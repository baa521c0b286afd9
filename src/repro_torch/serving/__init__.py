"""Serving stack of the port: engine, runner, paging, prefix cache,
scheduling policies, sampling, speculative decoding, the open-loop load
generator, tracing and stats."""
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kv_cache import BlockAllocator
from repro_torch.serving.loadgen import (ArrivalSpec, LoadSpec, PromptSpec,
                                         SLOSpec, TimedTask, arrival_times,
                                         make_trace, replay)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.runner import DecodeHandle, ModelRunner
from repro_torch.serving.sampling import SamplingParams, validate_sampling
from repro_torch.serving.scheduler import (ChunkedPrefillPolicy,
                                           DeadlinePolicy, FCFSPolicy,
                                           PriorityPolicy, SchedulerPolicy,
                                           make_policy)
from repro_torch.serving.spec import (DraftState, SpecConfig, resolve_draft,
                                      spec_support_reason)
from repro_torch.serving.stats import (EngineStats, Reservoir, percentile,
                                       percentiles)
from repro_torch.serving.tasks import (EncodeTask, GenerateTask, Rejection,
                                       Request, Task, TokenEvent,
                                       validate_task)
from repro_torch.serving.trace import (Tracer, derive_phase_metrics,
                                       prometheus_text, validate_chrome_trace)

__all__ = ["InferenceEngine", "BlockAllocator", "ArrivalSpec", "LoadSpec",
           "PromptSpec", "SLOSpec", "TimedTask", "arrival_times",
           "make_trace", "replay", "PrefixCache", "DecodeHandle",
           "ModelRunner", "SamplingParams", "validate_sampling",
           "SchedulerPolicy", "FCFSPolicy", "PriorityPolicy",
           "ChunkedPrefillPolicy", "DeadlinePolicy", "make_policy",
           "DraftState", "SpecConfig", "resolve_draft", "spec_support_reason",
           "EngineStats", "Reservoir", "percentile", "percentiles",
           "EncodeTask", "GenerateTask", "Rejection", "Request", "Task",
           "TokenEvent", "validate_task", "Tracer", "derive_phase_metrics",
           "prometheus_text", "validate_chrome_trace"]

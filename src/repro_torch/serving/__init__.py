"""Serving stack of the port: engine, runner, paging, prefix cache,
scheduling policies, sampling, speculative decoding, stats."""
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (ChunkedPrefillPolicy, FCFSPolicy,
                                           PriorityPolicy, SchedulerPolicy,
                                           make_policy)
from repro_torch.serving.spec import SpecConfig, spec_support_reason
from repro_torch.serving.tasks import (EncodeTask, GenerateTask, Request,
                                       TokenEvent)

__all__ = ["InferenceEngine", "PrefixCache", "SamplingParams",
           "SchedulerPolicy", "FCFSPolicy", "PriorityPolicy",
           "ChunkedPrefillPolicy", "make_policy", "SpecConfig",
           "spec_support_reason",
           "EncodeTask", "GenerateTask", "Request", "TokenEvent"]

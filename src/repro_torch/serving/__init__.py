"""Serving stack of the port: engine, runner, paging, sampling, stats."""
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.tasks import (EncodeTask, GenerateTask, Request,
                                       TokenEvent)

__all__ = ["InferenceEngine", "SamplingParams",
           "EncodeTask", "GenerateTask", "Request", "TokenEvent"]

"""Serving requests (copy of the reference's serving/tasks.py): `GenerateTask`
(alias `Request`) and `EncodeTask` are what a client wants, the scheduler
decides when they run, the runner how.  Both carry `priority` and
`deadline_ms` (a TTFT budget from submission: `DeadlinePolicy` orders
admission by its slack and sheds a request that provably cannot meet it,
attaching a typed `Rejection`); a GenerateTask also carries `slo_tpot_ms`,
scored at retirement.  `validate_task` runs at construction and again at
`InferenceEngine.submit`."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.serving.sampling import SamplingParams


def validate_task(task: "Task") -> None:
    """Reject unservable `priority` / `deadline_ms` / `slo_tpot_ms` /
    `pooling` values with a clear ValueError."""
    try:
        p = float(task.priority)
    except (TypeError, ValueError):
        raise ValueError(f"priority must be a real number: {task.priority!r}")
    if math.isnan(p) or math.isinf(p):
        raise ValueError(f"priority must be finite: {task.priority!r}")
    for name in ("deadline_ms", "slo_tpot_ms"):
        v = getattr(task, name, None)
        if v is None:
            continue
        try:
            f = float(v)
        except (TypeError, ValueError):
            raise ValueError(f"{name} must be a positive finite millisecond "
                             f"budget or None: {v!r}")
        if math.isnan(f) or math.isinf(f) or f <= 0:
            raise ValueError(f"{name} must be > 0 and finite; got {v!r}")
    pooling = getattr(task, "pooling", "last")
    if pooling not in ("last", "mean"):
        raise ValueError(f"pooling must be 'last' or 'mean': {pooling!r}")


@dataclass(frozen=True)
class Rejection:
    """Why a request was shed instead of served: attached to
    `task.rejection` (with done=True and no output) when the scheduler
    proves its SLO unattainable."""
    kind: str       # machine-readable, e.g. "slo_unattainable"
    detail: str     # human-readable explanation


def _require_keyword_prompt(task: "Task") -> None:
    if task.prompt is None:
        raise TypeError(f"{type(task).__name__} requires `prompt`; pass "
                        f"fields by keyword, e.g. "
                        f"{type(task).__name__}(uid=0, prompt=tokens)")


@dataclass
class Task:
    """Common serving-request state.  `uid` must be unique per engine."""
    uid: int
    priority: int = 0
    deadline_ms: Optional[float] = None
    # filled by the engine:
    prompt_len: int = 0
    bucket: int = 0
    queue_wait_ms: float = 0.0
    done: bool = False
    # set (with done=True) when the scheduler sheds this request; None for
    # every served request
    rejection: Optional[Rejection] = None
    _t_submit: float = field(default=0.0, repr=False)
    _seq: int = field(default=0, repr=False)   # admission order (preemption)

    def age_s(self, now: Optional[float] = None) -> float:
        """Seconds since submission."""
        return max(0.0, (now if now is not None else time.perf_counter())
                   - self._t_submit)

    def slack_ms(self, now: Optional[float] = None) -> float:
        """Milliseconds of deadline budget left (negative: already missed);
        +inf without a deadline."""
        if self.deadline_ms is None:
            return math.inf
        return self.deadline_ms - self.age_s(now) * 1e3


@dataclass
class GenerateTask(Task):
    """Decoder-LM request: prefill the prompt, then decode up to
    `max_new_tokens` AR steps (stopping early on `eos_id`)."""
    prompt: np.ndarray = None
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    slo_tpot_ms: Optional[float] = None
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    ttft_ms: float = 0.0
    latency_ms: float = 0.0
    tpot_ms: float = 0.0
    # True once served degraded (admitted under DeadlinePolicy pressure:
    # no speculation for this request); tokens never change, only latency
    degraded: bool = False
    # prompt tokens whose KV is in the cache (chunked prefill progress;
    # the full length once the first token is sampled)
    prefilled: int = 0
    # prompt tokens served from the prefix cache at the latest admission
    # (0 = cold)
    cached_prefix: int = 0

    def __post_init__(self):
        _require_keyword_prompt(self)
        validate_task(self)

    def remaining_prefill(self) -> int:
        return self.prompt_len + len(self.output) - self.prefilled


@dataclass
class EncodeTask(Task):
    """Encoder-only request: one full-sequence forward, pooled output; it
    takes no decode slot and no KV block.

    pooling   "last" — the normalized residual of the final true position
                       (the hidden state a prefill would sample from)
              "mean" — the masked mean over the true positions
    """
    prompt: np.ndarray = None           # [S_prompt] int32
    pooling: str = "last"
    # filled by the engine:
    embedding: Optional[np.ndarray] = None   # [d_model] float32 result
    encode_ms: float = 0.0              # amortized share of the batched pass
    latency_ms: float = 0.0             # submit -> result

    def __post_init__(self):
        _require_keyword_prompt(self)
        validate_task(self)


Request = GenerateTask


@dataclass(frozen=True)
class TokenEvent:
    """One streamed token, emitted by `InferenceEngine.generate()`."""
    uid: int
    token: int
    is_last: bool

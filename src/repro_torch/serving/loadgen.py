"""Deterministic open-loop load generation for goodput measurement (port
of the reference's serving/loadgen.py; the same spec and seeds give the
same trace in both packages).

Production serving is judged in goodput — requests/sec meeting their
TTFT/TPOT SLOs under sustained arrival pressure — which a closed
submit-all-then-drain trace cannot measure: arrival pressure must be
OPEN-LOOP (requests arrive on the trace's clock whether or not the engine
keeps up), or queueing collapse is invisible.  This module builds seeded,
reproducible traces and replays them against an `InferenceEngine`:

  ArrivalSpec   when requests arrive: "poisson" (exponential gaps at
                `rate_rps`) or "bursty" (Markov-modulated Poisson: the
                rate flips between a lo and a hi state with exponential
                dwell times — the flash-crowd shape real traffic has)
  PromptSpec    what arrives: prompt lengths uniform or long-tailed
                (Pareto), a shared-prefix fraction (prefix-cache traffic),
                an encoder-only fraction (EncodeTask blend), and a sampled
                fraction (vs greedy)
  SLOSpec       per-request budgets: `ttft_ms` -> task.deadline_ms,
                `tpot_ms` -> task.slo_tpot_ms
  make_trace()  LoadSpec -> [TimedTask], thousands if asked
  replay()      open-loop wall-clock submission harness

Seed discipline (tested): arrival timing and prompt content draw from two
INDEPENDENT numpy Generators, and each request's sampling seed is its uid
— so changing the traffic seed (`arrival_seed`) reshuffles *when* requests
arrive but never what any request computes, and a given uid's sampled
tokens are identical across traces, policies and loops.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.tasks import EncodeTask, GenerateTask, Task

# Domain-separation constants so arrival_seed == prompt_seed still yields
# independent streams (default_rng hashes the full key sequence).
_ARRIVAL_DOMAIN = 0x41525256        # "ARRV"
_PROMPT_DOMAIN = 0x50524D50         # "PRMP"


@dataclass(frozen=True)
class ArrivalSpec:
    """Arrival process.  kind="poisson": exponential inter-arrivals at
    `rate_rps`.  kind="bursty": Markov-modulated Poisson — the process
    dwells in a lo state (`rate_rps`) or a hi state (`burst_rate_rps`,
    default 4x) with exponential `dwell_s` mean holding times."""
    kind: str = "poisson"
    rate_rps: float = 8.0
    burst_rate_rps: float = 0.0     # 0 => 4 * rate_rps
    dwell_s: float = 1.0

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty"):
            raise ValueError(f"arrival kind must be 'poisson' or "
                             f"'bursty': {self.kind!r}")
        if not self.rate_rps > 0:
            raise ValueError(f"rate_rps must be > 0: {self.rate_rps}")
        if self.kind == "bursty" and not self.dwell_s > 0:
            raise ValueError(f"dwell_s must be > 0: {self.dwell_s}")

    @property
    def hi_rate(self) -> float:
        return self.burst_rate_rps or 4.0 * self.rate_rps


@dataclass(frozen=True)
class PromptSpec:
    """Prompt mix.  Lengths are uniform in [min_len, max_len] unless
    `tail_alpha` > 0, which draws min_len + Pareto(tail_alpha) clipped to
    max_len — a long-tail mix where most prompts are short and a few hit
    the cap.  `shared_frac` of requests open with one common prefix of
    `prefix_len` tokens (prefix-cache traffic); `encode_frac` arrive as
    EncodeTasks; `sampled_frac` of generate requests sample (temperature
    0.8, top-k 40), the rest are greedy."""
    min_len: int = 4
    max_len: int = 48
    tail_alpha: float = 0.0
    shared_frac: float = 0.0
    prefix_len: int = 0
    encode_frac: float = 0.0
    sampled_frac: float = 0.5

    def __post_init__(self):
        if not 1 <= self.min_len <= self.max_len:
            raise ValueError(f"need 1 <= min_len <= max_len: "
                             f"{self.min_len}..{self.max_len}")
        for name in ("shared_frac", "encode_frac", "sampled_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1]: {v}")
        if self.shared_frac > 0 and not 0 < self.prefix_len:
            raise ValueError("shared_frac > 0 needs prefix_len >= 1")
        if self.prefix_len > self.min_len:
            raise ValueError(f"prefix_len {self.prefix_len} exceeds "
                             f"min_len {self.min_len}")


@dataclass(frozen=True)
class SLOSpec:
    """Per-request budgets stamped onto every emitted task (None = no
    SLO): `ttft_ms` becomes `deadline_ms` (TTFT budget — DeadlinePolicy
    schedules and sheds on it), `tpot_ms` becomes `slo_tpot_ms` (checked
    at retirement for attainment accounting only)."""
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None


@dataclass(frozen=True)
class LoadSpec:
    requests: int
    vocab: int
    arrival: ArrivalSpec = field(default_factory=ArrivalSpec)
    prompts: PromptSpec = field(default_factory=PromptSpec)
    slo: SLOSpec = field(default_factory=SLOSpec)
    max_new: int = 8
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError(f"requests must be >= 1: {self.requests}")
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2: {self.vocab}")


@dataclass(frozen=True)
class TimedTask:
    """One trace entry: submit `task` when the trace clock passes `t_s`."""
    t_s: float
    task: Task


def arrival_times(spec: ArrivalSpec, n: int,
                  rng: np.random.Generator) -> np.ndarray:
    """[n] float64 seconds from trace start, nondecreasing."""
    if spec.kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / spec.rate_rps, n))
    # bursty (MMPP): walk lo/hi states with exponential dwells, drawing
    # exponential gaps at the current state's rate; a gap that crosses a
    # state flip is re-drawn from the flip point (memorylessness makes
    # this exact, not an approximation)
    times = np.empty(n)
    t = 0.0
    hi = False
    flip = rng.exponential(spec.dwell_s)
    for i in range(n):
        while True:
            rate = spec.hi_rate if hi else spec.rate_rps
            gap = rng.exponential(1.0 / rate)
            if t + gap <= flip:
                t += gap
                break
            t = flip
            hi = not hi
            flip = t + rng.exponential(spec.dwell_s)
        times[i] = t
    return times


def make_trace(spec: LoadSpec, *, arrival_seed: int = 0,
               prompt_seed: int = 0, uid0: int = 0) -> List[TimedTask]:
    """Build a deterministic open-loop trace.  Same (spec, seeds, uid0)
    => identical trace, always.  `arrival_seed` drives ONLY the arrival
    clock; `prompt_seed` drives ONLY prompt content/class; request uid
    `u` always samples with seed `u` — three independent axes."""
    rng_arr = np.random.default_rng([_ARRIVAL_DOMAIN, arrival_seed])
    rng_pr = np.random.default_rng([_PROMPT_DOMAIN, prompt_seed])
    p = spec.prompts
    times = arrival_times(spec.arrival, spec.requests, rng_arr)
    # the shared prefix is one draw per trace: every shared request opens
    # with the same tokens (what a prefix cache can actually reuse)
    prefix = (rng_pr.integers(0, spec.vocab, p.prefix_len, dtype=np.int32)
              if p.shared_frac > 0 else None)
    out: List[TimedTask] = []
    for i in range(spec.requests):
        uid = uid0 + i
        # per-request class/content draws all come from rng_pr, in a fixed
        # order, so the stream is reproducible position-by-position
        if p.tail_alpha > 0:
            n = p.min_len + int(rng_pr.pareto(p.tail_alpha) * p.min_len)
            n = min(n, p.max_len)
        else:
            n = int(rng_pr.integers(p.min_len, p.max_len + 1))
        tokens = rng_pr.integers(0, spec.vocab, n, dtype=np.int32)
        is_enc = rng_pr.random() < p.encode_frac
        is_shared = prefix is not None and rng_pr.random() < p.shared_frac
        is_sampled = rng_pr.random() < p.sampled_frac
        if is_shared:
            tokens = np.concatenate([prefix, tokens[p.prefix_len:]])
        if is_enc:
            task: Task = EncodeTask(uid=uid, prompt=tokens,
                                    deadline_ms=spec.slo.ttft_ms)
        else:
            sampling = (SamplingParams(temperature=0.8, top_k=40, seed=uid)
                        if is_sampled else SamplingParams())
            task = GenerateTask(uid=uid, prompt=tokens,
                                max_new_tokens=spec.max_new,
                                eos_id=spec.eos_id, sampling=sampling,
                                deadline_ms=spec.slo.ttft_ms,
                                slo_tpot_ms=spec.slo.tpot_ms)
        out.append(TimedTask(float(times[i]), task))
    return out


def replay(engine, trace: List[TimedTask], *, time_scale: float = 1.0,
           max_steps: int = 200_000) -> Tuple[List[Task], float]:
    """Open-loop wall-clock replay: submit each task once the (scaled)
    clock passes its arrival time — arrivals never wait for the engine,
    which is exactly what makes over-capacity pressure measurable — and
    step the engine in between.  `time_scale=0` collapses the clock
    (every arrival is due immediately: a closed-loop batch, useful for
    warmup and capacity calibration).  Returns (tasks completed during
    this call — served AND shed, wall seconds)."""
    trace = sorted(trace, key=lambda tt: tt.t_s)
    start = len(engine.completed)
    i = 0
    t0 = time.perf_counter()
    steps = 0
    while (i < len(trace) or engine.has_work()) and steps < max_steps:
        now = (math.inf if time_scale <= 0
               else (time.perf_counter() - t0) / time_scale)
        while i < len(trace) and trace[i].t_s <= now:
            engine.submit(trace[i].task)
            i += 1
        if engine.has_work():
            engine.step()
            steps += 1
        elif i < len(trace):
            # idle until the next arrival: sleep in sub-ms slices so a
            # due arrival is picked up promptly
            wait = (trace[i].t_s - now) * max(time_scale, 1e-9)
            time.sleep(min(max(wait, 0.0), 0.0005))
    wall = time.perf_counter() - t0
    return engine.completed[start:], wall

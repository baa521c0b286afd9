"""Per-request sampling parameters (copy of the reference's
serving/sampling.py).  Lanes are host numpy arrays, one row per decode slot;
`device_lane` copies one to the device, where the model's sampler reads it
(the decode step copies the runner's lane into its own static buffers)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.embedding import TOP_K_CAP

# the lanes hold int32 seeds, as the reference's do: a wider seed would
# alias another (7 and 2**32 + 7 would draw the same noise)
SEED_MIN, SEED_MAX = -2**31, 2**31 - 1


def validate_sampling(params: "SamplingParams") -> None:
    """Reject unservable sampling parameters with a clear ValueError."""
    if params.temperature < 0:
        raise ValueError(
            f"temperature must be >= 0 (0 = greedy): {params.temperature}")
    if params.top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = full vocabulary): "
                         f"{params.top_k}")
    if params.top_k > TOP_K_CAP:
        raise ValueError(f"top_k {params.top_k} exceeds TOP_K_CAP="
                         f"{TOP_K_CAP}; pass top_k <= {TOP_K_CAP}, or 0")
    if not SEED_MIN <= params.seed <= SEED_MAX:
        raise ValueError(f"seed {params.seed} is outside the int32 lane "
                         f"[{SEED_MIN}, {SEED_MAX}]")


@dataclass(frozen=True)
class SamplingParams:
    """temperature 0 => greedy; top_k 0 => full vocabulary; seed: the
    request's RNG lane — (seed, position) maps to one draw regardless of
    batching or slot placement."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        validate_sampling(self)

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def zero_lane(batch_size: int) -> dict:
    """Fresh per-slot lane arrays (all slots greedy)."""
    return {"temperature": np.zeros((batch_size,), np.float32),
            "top_k": np.zeros((batch_size,), np.int32),
            "seed": np.zeros((batch_size,), np.int32)}


def set_lane(lane: dict, slot: int, params: SamplingParams) -> dict:
    """Scatter one request's SamplingParams into slot `slot` (returns a new
    lane; the input is not mutated)."""
    out = {k: v.copy() for k, v in lane.items()}
    out["temperature"][slot] = params.temperature
    out["top_k"][slot] = params.top_k
    out["seed"][slot] = params.seed
    return out


def device_lane(lane: dict, device) -> dict:
    """Host lane -> device tensors for a step call (copies: a later host
    mutation never reaches them)."""
    return {k: torch.tensor(v, device=device) for k, v in lane.items()}


def stack_lanes(params_list) -> dict:
    """Lane arrays for a row batch of SamplingParams."""
    return {"temperature": np.asarray([p.temperature for p in params_list],
                                      np.float32),
            "top_k": np.asarray([p.top_k for p in params_list], np.int32),
            "seed": np.asarray([p.seed for p in params_list], np.int32)}

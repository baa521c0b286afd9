"""Declarative prologue/epilogue specs for the fused GEMM (port of the
reference's kernels/epilogue.py).

  ``Prologue``   normalize the GEMM's `a` operand: RMSNorm commutes with the
                 contraction, LayerNorm decomposes with two extra streamed
                 accumulators (`gamma @ W`, `beta @ W`).
  ``Epilogue``   bias + activation + residual-add + output cast applied to
                 the fp32 accumulator before the single output store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

NORM_KINDS = ("rmsnorm", "layernorm")
ACTIVATION_KINDS = ("none", "gelu", "gelu_exact", "i_gelu", "silu")

# Canonical norm-statistics epsilons, shared by the fused and unfused paths.
RMS_EPS = 1e-6
LN_EPS = 1e-5


@dataclass(frozen=True)
class Prologue:
    """Fused pre-norm of the GEMM's `a` operand: kind, gamma [K], beta [K]
    (layernorm only), eps."""
    kind: str
    scale: Any
    bias: Any = None
    eps: float = RMS_EPS

    def __post_init__(self):
        if self.kind not in NORM_KINDS:
            raise ValueError(f"unknown norm kind {self.kind!r}")
        if self.kind == "layernorm" and self.bias is None:
            raise ValueError("layernorm prologue needs beta")


@dataclass(frozen=True)
class Epilogue:
    """``cast(act(acc + bias)) + residual``.  `out_dtype` None: the
    residual's dtype when one is given, else the GEMM's `dot_dtype`."""
    activation: str = "none"
    bias: Any = None
    residual: Any = None
    out_dtype: Any = None

    def __post_init__(self):
        if self.activation not in ACTIVATION_KINDS:
            raise ValueError(f"unknown activation {self.activation!r}")


def norm_prologue(params: dict, kind: str) -> Prologue:
    """Prologue from a block's norm parameter dict ({"scale"[, "bias"]})."""
    if kind == "rmsnorm":
        return Prologue("rmsnorm", params["scale"], eps=RMS_EPS)
    return Prologue("layernorm", params["scale"], params["bias"], eps=LN_EPS)

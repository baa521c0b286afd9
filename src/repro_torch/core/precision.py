"""Precision policies (paper T6), on torch dtypes.

GEMMs run at the policy compute dtype and accumulate in fp32; softmax and
normalization statistics always run in fp32.  The port serves the fp32 and
bf16 policies of the reference's core/precision.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    name: str
    param_dtype: torch.dtype      # storage dtype of the weights
    compute_dtype: torch.dtype    # GEMM operand dtype
    accum_dtype: torch.dtype      # GEMM accumulation dtype
    softmax_dtype: torch.dtype    # softmax / norm statistics dtype


FP32 = Policy("fp32", torch.float32, torch.float32, torch.float32,
              torch.float32)
BF16 = Policy("bf16", torch.bfloat16, torch.bfloat16, torch.float32,
              torch.float32)

POLICIES = {p.name: p for p in (FP32, BF16)}

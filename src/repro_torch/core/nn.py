"""GEMM helpers with the paper's precision rules (T6): operands in the policy
compute dtype, fp32 accumulation, activations carried in the compute dtype.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import Policy
from repro_torch.kernels import ops


def act_dtype(policy: Policy):
    return policy.compute_dtype


def pdot(x, w, policy: Policy, *, out_dtype=None):
    """x: [..., K] @ w: [K, N] in the policy compute dtype, fp32 accumulation,
    emitted as `out_dtype` (default: the activation dtype): `ops.pdot`."""
    return ops.pdot(x, w, compute_dtype=policy.compute_dtype,
                    out_dtype=out_dtype or act_dtype(policy))


def fused_pdot(x, w, policy: Policy, *, prologue=None, epilogue=None,
               out_dtype=None):
    """`pdot` with an optional fused norm prologue / bias-activation-residual
    epilogue: those go through the fused GEMM (`ops.fused_matmul`)."""
    if prologue is None and epilogue is None:
        return pdot(x, w, policy, out_dtype=out_dtype)
    od = out_dtype or act_dtype(policy)
    return ops.fused_matmul(x, w, prologue=prologue, epilogue=epilogue,
                            compute_dtype=policy.compute_dtype, dot_dtype=od)

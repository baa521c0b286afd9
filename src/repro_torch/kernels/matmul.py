"""Fused GEMM: norm prologue -> A @ B -> bias / activation / residual epilogue.

Replaces the TPU kernel `src/repro/kernels/matmul.py:matmul`
(`_fused_mm_kernel`).  The CUDA source is `csrc/fused_matmul.cu`; its note
says what bounds the kernel on an H100 and how the design answers it.

`matmul_plain` is the kernel's arithmetic in plain PyTorch: fp32 operands
(the prologue scales A by gamma in fp32 and the weight is upcast), fp32
accumulation, the deferred RMSNorm / LayerNorm finalize, fp32 epilogue, one
cast at the store.  It differs from `ref.fused_matmul_ref` — which
normalizes first and casts to the compute dtype before the dot — by bf16
rounding only.  `fused_matmul` launches the kernel for CUDA tensors and
takes `matmul_plain` for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.activations import get_activation
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import RMS_EPS

_NORM = {"none": 0, "rmsnorm": 1, "layernorm": 2}
_ACT = {"none": 0, "gelu": 1, "gelu_exact": 2, "i_gelu": 3, "silu": 4}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]


def matmul_plain(a, b, *, norm="none", gamma=None, nbeta=None, bias=None,
                 residual=None, activation="none", eps=RMS_EPS,
                 out_dtype=None):
    """act(norm(A) @ B + bias) + residual with the kernel's fp32 math.
    A: [M, K], B: [K, N]."""
    out_dtype = out_dtype or (residual.dtype if residual is not None
                              else a.dtype)
    af, bf = a.float(), b.float()
    K = a.shape[-1]
    if norm == "none":
        y = af @ bf
    else:
        g = gamma.float()
        y = (af * g) @ bf
        s2 = (af * af).sum(-1, keepdim=True)
        if norm == "rmsnorm":
            y = y * torch.rsqrt(s2 / K + eps)
        else:
            mu = af.sum(-1, keepdim=True) / K
            var = s2 / K - mu * mu
            y = (y - mu * (g @ bf)) * torch.rsqrt(var + eps)
            y = y + nbeta.float() @ bf
    if bias is not None:
        y = y + bias.float()
    if activation != "none":
        y = get_activation(activation)(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def fused_matmul(a, b, *, norm="none", gamma=None, nbeta=None, bias=None,
                 residual=None, activation="none", eps=RMS_EPS,
                 out_dtype=None):
    """The fused GEMM.  A: [M, K], B: [K, N] -> [M, N] at `out_dtype`
    (default: the residual's dtype, else A's)."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, norm=norm, gamma=gamma, nbeta=nbeta,
                            bias=bias, residual=residual,
                            activation=activation, eps=eps,
                            out_dtype=out_dtype)
    out_dtype = out_dtype or (residual.dtype if residual is not None
                              else a.dtype)
    build.require_cuda("fused_matmul", a, b, gamma, nbeta, bias, residual)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fused_matmul: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    vecs = [v for v in (gamma, nbeta, bias) if v is not None]
    vec_dtype = vecs[0].dtype if vecs else torch.float32
    gamma, nbeta, bias = (None if v is None else v.to(vec_dtype).contiguous()
                          for v in (gamma, nbeta, bias))
    if residual is not None:
        residual = residual.reshape(M, N).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = build.bind("fused_matmul", "repro_fused_matmul", _ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(ptr(a), ptr(b), ptr(gamma), ptr(nbeta), ptr(bias),
             ptr(residual), ptr(out), M, N, K,
             build.dtype_code(a), build.dtype_code(b),
             build.dtype_code(vecs[0]) if vecs else 0,
             build.dtype_code(residual) if residual is not None else 0,
             build.dtype_code(out), _NORM[norm], _ACT[activation], float(eps),
             int(K % 4 == 0 and build.aligned16(a)),
             int(N % 4 == 0 and build.aligned16(b)),
             build.stream_of(a))
    build.check(err, "fused_matmul launch")
    fused_matmul.launches += 1
    return out


fused_matmul.launches = 0

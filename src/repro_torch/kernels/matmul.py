"""Fused GEMMs: norm prologue -> A @ B -> epilogue, plain and gated.

`fused_matmul` replaces the TPU kernel `src/repro/kernels/matmul.py:matmul`
(`_fused_mm_kernel`); its CUDA source is `csrc/fused_matmul.cu`.
`matmul_swiglu` replaces `matmul.py:matmul_swiglu` (`_fused_gated_kernel`):
silu(norm(A) @ Bg) * (norm(A) @ Bu) + residual in one pass, CUDA source
`csrc/fused_swiglu.cu`.  Each source's note says what bounds the kernel on
an H100 and how the design answers it.

`matmul_plain` is the kernel's arithmetic in plain PyTorch: fp32 operands
(the prologue scales A by gamma in fp32 and the weight is upcast), fp32
accumulation, the deferred RMSNorm / LayerNorm finalize, fp32 epilogue, one
cast at the store; `matmul_swiglu_plain` does the same for both gated
products, then silu(g) * u in fp32.  It differs from `ref.fused_matmul_ref` — which
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
_SWIGLU_ARGTYPES = [_P] * 7 + [_I] * 9 + [ctypes.c_float, _I, _I, _P]


def _normed_product(a, b, norm, gamma, nbeta, eps):
    """norm(A) @ B in fp32 the kernels' way: A scaled by gamma in fp32,
    the weight upcast, the norm statistics applied after the product."""
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
    return y


def _out_dtype(a, residual, out_dtype):
    return out_dtype or (residual.dtype if residual is not None else a.dtype)


def matmul_plain(a, b, *, norm="none", gamma=None, nbeta=None, bias=None,
                 residual=None, activation="none", eps=RMS_EPS,
                 out_dtype=None):
    """act(norm(A) @ B + bias) + residual with the kernel's fp32 math.
    A: [M, K], B: [K, N]."""
    out_dtype = _out_dtype(a, residual, out_dtype)
    y = _normed_product(a, b, norm, gamma, nbeta, eps)
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
    out_dtype = _out_dtype(a, residual, out_dtype)
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


def matmul_swiglu_plain(a, b_gate, b_up, *, norm="none", gamma=None,
                        nbeta=None, residual=None, eps=RMS_EPS,
                        out_dtype=None):
    """silu(norm(A) @ Bg) * (norm(A) @ Bu) + residual with the kernel's
    fp32 math.  A: [M, K]; Bg, Bu: [K, N]."""
    out_dtype = _out_dtype(a, residual, out_dtype)
    g = _normed_product(a, b_gate, norm, gamma, nbeta, eps)
    u = _normed_product(a, b_up, norm, gamma, nbeta, eps)
    y = torch.nn.functional.silu(g) * u
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _check_swiglu(a, b_gate, b_up, norm, gamma, nbeta, residual):
    """Raise on operands the gated kernel does not take."""
    build.require_cuda("matmul_swiglu", a, b_gate, b_up, gamma, nbeta,
                       residual)
    ok = (a.ndim == 2 and b_gate.ndim == 2 and b_gate.shape == b_up.shape
          and a.shape[1] == b_gate.shape[0] and b_gate.dtype == b_up.dtype
          and norm in _NORM and (norm == "none" or gamma is not None)
          and (norm != "layernorm" or nbeta is not None))
    if not ok:
        raise ValueError(f"matmul_swiglu: unsupported operands "
                         f"{tuple(a.shape)} @ {tuple(b_gate.shape)} / "
                         f"{tuple(b_up.shape)}, norm {norm!r}")
    if residual is not None and residual.numel() != a.shape[0] * \
            b_gate.shape[1]:
        raise ValueError(f"matmul_swiglu: residual {tuple(residual.shape)} "
                         f"does not match the output")


def matmul_swiglu(a, b_gate, b_up, *, norm="none", gamma=None, nbeta=None,
                  residual=None, eps=RMS_EPS, out_dtype=None):
    """The fused gated GEMM.  A: [M, K]; Bg, Bu: [K, N] -> [M, N] at
    `out_dtype` (default: the residual's dtype, else A's)."""
    if a.device.type == "cpu":
        return matmul_swiglu_plain(a, b_gate, b_up, norm=norm, gamma=gamma,
                                   nbeta=nbeta, residual=residual, eps=eps,
                                   out_dtype=out_dtype)
    out_dtype = _out_dtype(a, residual, out_dtype)
    _check_swiglu(a, b_gate, b_up, norm, gamma, nbeta, residual)
    M, K = a.shape
    N = b_gate.shape[1]
    a, b_gate, b_up = a.contiguous(), b_gate.contiguous(), b_up.contiguous()
    vec_dtype = gamma.dtype if gamma is not None else torch.float32
    gamma, nbeta = (None if v is None else v.to(vec_dtype).contiguous()
                    for v in (gamma, nbeta))
    if residual is not None:
        residual = residual.reshape(M, N).contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = build.bind("fused_swiglu", "repro_fused_swiglu", _SWIGLU_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(ptr(a), ptr(b_gate), ptr(b_up), ptr(gamma), ptr(nbeta),
             ptr(residual), ptr(out), M, N, K,
             build.dtype_code(a), build.dtype_code(b_gate),
             build.dtype_code(gamma) if gamma is not None else 0,
             build.dtype_code(residual) if residual is not None else 0,
             build.dtype_code(out), _NORM[norm], float(eps),
             int(K % 4 == 0 and build.aligned16(a)),
             int(N % 4 == 0 and build.aligned16(b_gate, b_up)),
             build.stream_of(a))
    build.check(err, "matmul_swiglu launch")
    matmul_swiglu.launches += 1
    return out


matmul_swiglu.launches = 0

"""Row norms: RMSNorm and LayerNorm with fp32 statistics, alone or behind
a residual add.

Replace the TPU kernels `src/repro/kernels/rmsnorm.py:rmsnorm`
(`_rms_kernel`), `:layernorm` (`_ln_kernel`), `:residual_rmsnorm`
(`_res_rms_kernel`) and `:residual_layernorm` (`_res_ln_kernel`).  All
come from one CUDA source, `csrc/rmsnorm.cu`: `norm_kernel` and
`res_norm_kernel` share one register tile that holds each row and reads it
once (picked by D inside the C entry points, a looped path for a row that
fits no tile); the residual form rounds r = x + y in the registers, stores
it and normalizes what it stored.  The source's note says what bounds them
on an H100 and how the design answers it.  The wrappers keep
the host light: `build` binds each C entry point once and maps dtype codes
from a dict, and only the copies and casts that do something are made.

`rmsnorm_plain` / `layernorm_plain` are the kernels' arithmetic in plain
PyTorch: fp32 row statistics (LayerNorm's mean, then its variance about
the mean), fp32 normalize and scale, one cast to x's dtype.  The residual
forms add in fp32, round r = x + y to x's dtype and normalize r as stored.
The wrappers launch the kernel for CUDA tensors and take the plain version
for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.epilogue import LN_EPS, RMS_EPS

_KIND = {"rmsnorm": 1, "layernorm": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]
_RES_ARGTYPES = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P]


def rmsnorm_plain(x, gamma, *, eps=RMS_EPS):
    xf = x.float()
    ss = (xf * xf).sum(-1, keepdim=True)
    y = xf * torch.rsqrt(ss / x.shape[-1] + eps) * gamma.float()
    return y.to(x.dtype)


def layernorm_plain(x, gamma, beta, *, eps=LN_EPS):
    xf = x.float()
    D = x.shape[-1]
    mu = xf.sum(-1, keepdim=True) / D
    d = xf - mu
    rstd = torch.rsqrt((d * d).sum(-1, keepdim=True) / D + eps)
    return (d * rstd * gamma.float() + beta.float()).to(x.dtype)


def residual_rmsnorm_plain(x, y, gamma, *, eps=RMS_EPS):
    r = (x.float() + y.float()).to(x.dtype)
    return rmsnorm_plain(r, gamma, eps=eps), r


def residual_layernorm_plain(x, y, gamma, beta, *, eps=LN_EPS):
    r = (x.float() + y.float()).to(x.dtype)
    return layernorm_plain(r, gamma, beta, eps=eps), r


def _operands(what, x, gamma, beta):
    """Check the operands the kernels take and make them contiguous, with
    beta at gamma's dtype, copying or casting only where that changes
    something."""
    D = x.shape[-1]
    if (D == 0 or gamma.shape != (D,)
            or (beta is not None and beta.shape != (D,))):
        raise ValueError(f"{what}: unsupported operands x {tuple(x.shape)}, "
                         f"gamma {tuple(gamma.shape)}")
    build.require_cuda(what, x, gamma, beta)
    if not x.is_contiguous():
        x = x.contiguous()
    if not gamma.is_contiguous():
        gamma = gamma.contiguous()
    if beta is not None and (beta.dtype != gamma.dtype
                             or not beta.is_contiguous()):
        beta = beta.to(gamma.dtype).contiguous()
    return x, gamma, beta


def _launch(kind, x, gamma, beta, eps):
    x, gamma, beta = _operands(kind, x, gamma, beta)
    D = x.shape[-1]
    out = torch.empty_like(x)
    err = build.bind("rmsnorm", "repro_norm", _ARGTYPES)(
        x.data_ptr(), gamma.data_ptr(),
        None if beta is None else beta.data_ptr(), out.data_ptr(),
        x.numel() // D, D, build.dtype_code(x), build.dtype_code(gamma),
        _KIND[kind], eps, build.stream_of(x))
    if err:
        build.check(err, f"{kind} launch")
    return out


def rmsnorm(x, gamma, *, eps=RMS_EPS):
    """x: [..., D]; gamma: [D] -> same shape and dtype as x."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gamma, eps=eps)
    out = _launch("rmsnorm", x, gamma, None, eps)
    rmsnorm.launches += 1
    return out


def layernorm(x, gamma, beta, *, eps=LN_EPS):
    """x: [..., D]; gamma, beta: [D] -> same shape and dtype as x."""
    if x.device.type == "cpu":
        return layernorm_plain(x, gamma, beta, eps=eps)
    out = _launch("layernorm", x, gamma, beta, eps)
    layernorm.launches += 1
    return out


def _launch_residual(kind, x, y, gamma, beta, eps):
    what = f"residual_{kind}"
    x, gamma, beta = _operands(what, x, gamma, beta)
    if y.shape != x.shape or y.device != x.device:
        raise ValueError(f"{what}: y {tuple(y.shape)} on {y.device} is not "
                         f"shaped as x {tuple(x.shape)} on {x.device}")
    if not y.is_contiguous():
        y = y.contiguous()
    D = x.shape[-1]
    h, r = torch.empty_like(x), torch.empty_like(x)
    err = build.bind("rmsnorm", "repro_residual_norm", _RES_ARGTYPES)(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(),
        None if beta is None else beta.data_ptr(), h.data_ptr(),
        r.data_ptr(), x.numel() // D, D, build.dtype_code(x),
        build.dtype_code(y), build.dtype_code(gamma), _KIND[kind], eps,
        build.stream_of(x))
    if err:
        build.check(err, f"{what} launch")
    return h, r


def residual_rmsnorm(x, y, gamma, *, eps=RMS_EPS):
    """r = x + y (stored in x's dtype); h = rmsnorm(r) -> (h, r)."""
    if x.device.type == "cpu":
        return residual_rmsnorm_plain(x, y, gamma, eps=eps)
    out = _launch_residual("rmsnorm", x, y, gamma, None, eps)
    residual_rmsnorm.launches += 1
    return out


def residual_layernorm(x, y, gamma, beta, *, eps=LN_EPS):
    """r = x + y (stored in x's dtype); h = layernorm(r) -> (h, r)."""
    if x.device.type == "cpu":
        return residual_layernorm_plain(x, y, gamma, beta, eps=eps)
    out = _launch_residual("layernorm", x, y, gamma, beta, eps)
    residual_layernorm.launches += 1
    return out


rmsnorm.launches = 0
layernorm.launches = 0
residual_rmsnorm.launches = 0
residual_layernorm.launches = 0

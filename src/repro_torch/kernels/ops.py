"""Kernel dispatch: hand-written CUDA kernels <-> plain PyTorch.

Every model-facing op of the port goes through this module.  Modes:

  ``auto``  (default) by the tensor's device: a CUDA tensor launches the
            hand-written kernel (or raises), a CPU tensor takes the kernel's
            plain PyTorch version.  No `try` falls back from one to the other.
  ``cuda``  the kernel, always; a CPU tensor raises.
  ``ref``   the line-for-line port of the reference's kernels/ref.py.

Set with `set_mode` / `kernel_mode(...)`, or the environment variable
`REPRO_TORCH_KERNEL_MODE` (validated when read: an unknown mode raises).
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _norm
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels.epilogue import (LN_EPS, RMS_EPS, Epilogue, Prologue,
                                          norm_prologue)

__all__ = [
    "Epilogue", "Prologue", "norm_prologue", "get_mode", "set_mode",
    "kernel_mode", "flash_attention", "decode_attention",
    "paged_decode_attention",
    "paged_decode_partials", "paged_decode_merge",
    "split_quantized", "matmul", "pdot", "fused_matmul",
    "matmul_swiglu", "fused_matmul_swiglu", "residual_norm", "rmsnorm",
    "layernorm", "norm", "ssd", "ssd_decode", "launch_counters",
]

_STATE = threading.local()
_VALID = ("auto", "cuda", "ref")


def _default_mode() -> str:
    mode = os.environ.get("REPRO_TORCH_KERNEL_MODE", "auto")
    if mode not in _VALID:
        raise ValueError(
            f"REPRO_TORCH_KERNEL_MODE={mode!r} is not a valid kernel mode; "
            f"expected one of {_VALID}")
    return mode


def get_mode() -> str:
    return getattr(_STATE, "mode", None) or _default_mode()


def set_mode(mode: str) -> None:
    if mode not in _VALID:
        raise ValueError(f"kernel mode {mode!r} not in {_VALID}")
    _STATE.mode = mode


@contextlib.contextmanager
def kernel_mode(mode: str):
    prev = getattr(_STATE, "mode", None)
    set_mode(mode)
    try:
        yield
    finally:
        _STATE.mode = prev


def _use_kernel(x) -> bool:
    """True: call the kernel wrapper (which launches for CUDA tensors and
    takes the plain version for CPU tensors); False: the ref.py port."""
    mode = get_mode()
    if mode == "ref":
        return False
    if mode == "cuda" and x.device.type != "cuda":
        raise ValueError(f"kernel mode 'cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    return True


def launch_counters() -> dict:
    """The hand-written kernels' wrappers by name.  Each adds one to its
    `launches` (and to `launches_by[form]`, where it has several: the
    GEMMs' template and weight form, flash's template, the paged decode's
    pool dtype) where it launches its kernel; a replayed CUDA graph adds
    the counts of its capture (`launch/steps.py`)."""
    return {"fused_matmul": _mm.fused_matmul,
            "fused_matmul_swiglu": _mm.matmul_swiglu,
            "flash_attention": _fa.flash_attention,
            "paged_decode_partials": _fd.paged_decode_partials,
            "paged_decode_attention": _fd.paged_decode_attention,
            "paged_decode_merge": _fd.paged_decode_merge,
            "decode_attention": _fd.decode_attention,
            "rmsnorm": _norm.rmsnorm,
            "layernorm": _norm.layernorm,
            "residual_rmsnorm": _norm.residual_rmsnorm,
            "residual_layernorm": _norm.residual_layernorm,
            "ssd": _ssd.ssd}


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] -> [B, Sq, H, D].  The port
    passes a static int `q_offset`, so the kernel always applies."""
    if _use_kernel(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, block_kv=512)


def decode_attention(q, k_cache, v_cache, length, *, window=0):
    """Single-token decode over dense per-slot caches.  q: [B, H, D];
    k/v_cache: [B, S, KV, D]; length: [B] valid positions;
    `window` > 0: only the last `window` of them attend."""
    if _use_kernel(q):
        return _fd.decode_attention(q, k_cache, v_cache, length,
                                    window=window)
    return _ref.decode_attention_ref(q, k_cache, v_cache, length,
                                     window=window)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None):
    """Block-paged decode, normalized.  q: [B, H, D]; k/v_pool:
    [NB, BS, KV, D]; block_tables: [B, MB] (< 0 absent); lengths: [B].
    `k_scale` / `v_scale` ([NB, KV] fp32): the scales of int8 pools."""
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if _use_kernel(q):
        return _fd.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                          lengths, **sc)
    return _ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                           lengths, **sc)


def paged_decode_partials(q, k_pool, v_pool, block_tables, lengths,
                          splits=1, *, k_scale=None, v_scale=None):
    """Block-paged decode partials -> (o unnormalized fp32 [B, H, D],
    m [B, H], l [B, H]) for the online-softmax merge; with `splits` > 1 the
    table's entries are cut into that many contiguous ranges and each
    output gains a leading [splits] dimension.  `ref` mode runs the oracle
    once per range, with the entries outside it absent.  `k_scale` /
    `v_scale`: the scales of int8 pools."""
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if _use_kernel(q):
        return _fd.paged_decode_partials(q, k_pool, v_pool, block_tables,
                                         lengths, splits, **sc)
    if splits <= 1:
        return _ref.paged_decode_partials_ref(q, k_pool, v_pool,
                                              block_tables, lengths, **sc)
    entry = torch.arange(block_tables.shape[1], device=block_tables.device)
    parts = [_ref.paged_decode_partials_ref(
        q, k_pool, v_pool,
        torch.where((entry >= e0) & (entry < e1), block_tables,
                    torch.full_like(block_tables, -1)), lengths, **sc)
        for e0, e1 in _fd.split_ranges(block_tables.shape[1], splits)]
    return tuple(torch.stack(x) for x in zip(*parts))


def paged_decode_merge(o, m, l, *, out_dtype):
    """Merge split partials (o [S, B, H, D], m, l [S, B, H]) with the
    online-softmax rule -> [B, H, D] at `out_dtype`; `ref` mode applies the
    rule in plain PyTorch."""
    if _use_kernel(o):
        return _fd.paged_decode_merge(o, m, l, out_dtype=out_dtype)
    return _fd.paged_decode_merge_plain(o, m, l, out_dtype=out_dtype)


# --------------------------------------------------------------------------
# GEMM + fused prologue / epilogue
# --------------------------------------------------------------------------

def split_quantized(w):
    """A weight-only int8 leaf ({"q": int8 [K, N], "scale": fp32 [N]},
    `models/quantize.quantize_params`) -> (q, scale); a plain tensor passes
    through as (w, None).  Every GEMM entry point takes either: on the card
    an int8 q runs the kernels' int8 form (never a widened bf16 copy), in
    `ref` mode and on the CPU the plain form."""
    if isinstance(w, dict):
        return w["q"], w["scale"]
    return w, None


def _wcast(w, scale, cd):
    """The weight the contraction reads: an int8 q as it is (with its
    scale), any other weight at the compute dtype."""
    return w if scale is not None else w.to(cd)


def matmul(a, b, *, activation="none", out_dtype=None):
    """C = act(A @ B); A: [..., K], B: [K, N] (or an int8 dict)."""
    b, b_scale = split_quantized(b)
    if _use_kernel(a):
        lead = a.shape[:-1]
        y = _mm.fused_matmul(a.reshape(-1, a.shape[-1]), b,
                             activation=activation, out_dtype=out_dtype,
                             b_scale=b_scale)
        return y.reshape(*lead, b.shape[-1])
    if b_scale is not None:
        return _ref.fused_matmul_ref(a, b, w_scale=b_scale,
                                     activation=activation,
                                     compute_dtype=a.dtype,
                                     dot_dtype=out_dtype,
                                     out_dtype=out_dtype or a.dtype)
    return _ref.matmul_ref(a, b, activation=activation, out_dtype=out_dtype)


def _prologue_fields(prologue):
    if prologue is None:
        return dict(norm="none", gamma=None, nbeta=None, eps=RMS_EPS)
    return dict(norm=prologue.kind, gamma=prologue.scale, nbeta=prologue.bias,
                eps=prologue.eps)


def pdot(x, w, *, compute_dtype, out_dtype):
    """x: [..., K] @ w: [K, N] with operands at `compute_dtype`, fp32
    accumulation, emitted as `out_dtype` (the reference's unfused dot, an
    XLA dot with preferred_element_type fp32).  A bf16 product on the card
    runs the hand GEMM with no prologue and no epilogue: exact bf16
    products summed in fp32, the same function.  The CPU, `ref` mode and
    an fp32 compute dtype keep the fp32 product `_dot`.

    An int8 weight dict: on the card the hand GEMM's int8 form (the scale
    on the fp32 accumulator, one rounding); elsewhere the reference's
    order, a dot at `out_dtype` on q at the compute dtype (exact: |q| <=
    127), then the scale in fp32, then a cast."""
    q, scale = split_quantized(w)
    if (_use_kernel(x) and x.device.type != "cpu"
            and compute_dtype == torch.bfloat16):
        return fused_matmul(x, w, compute_dtype=compute_dtype,
                            dot_dtype=out_dtype)
    y = _ref._dot(x.to(compute_dtype), q.to(compute_dtype), out_dtype)
    if scale is not None:
        y = (y.float() * scale.float()).to(out_dtype)
    return y


def fused_matmul(x, w, *, prologue=None, epilogue=None, compute_dtype=None,
                 dot_dtype=None):
    """y = epilogue(norm(x) @ w);  x: [..., K], w: [K, N] -> [..., N].

    `compute_dtype`: operand dtype of the contraction; `dot_dtype`: what
    the unfused `pdot` would emit (the output dtype when the epilogue names
    none).  The kernel keeps a normalized operand in fp32, as the TPU
    kernel does; only an un-normalized x is cast to the compute dtype.  An
    int8 weight dict runs the kernel's int8 form (plain: `fused_matmul_ref`
    with its scale)."""
    w, w_scale = split_quantized(w)
    ep = epilogue or Epilogue()
    out_dtype = ep.out_dtype or dot_dtype or x.dtype
    pf = _prologue_fields(prologue)
    if _use_kernel(x):
        lead = x.shape[:-1]
        K, N = x.shape[-1], w.shape[-1]
        cd = compute_dtype or x.dtype
        x2 = x.reshape(-1, K)
        if prologue is None:
            x2 = x2.to(cd)
        res2 = (ep.residual.reshape(-1, N) if ep.residual is not None
                else None)
        out = _mm.fused_matmul(x2, _wcast(w, w_scale, cd), bias=ep.bias,
                               residual=res2, activation=ep.activation,
                               out_dtype=out_dtype, b_scale=w_scale, **pf)
        return out.reshape(*lead, N)
    return _ref.fused_matmul_ref(
        x, w, w_scale=w_scale, bias=ep.bias, residual=ep.residual,
        activation=ep.activation, compute_dtype=compute_dtype,
        dot_dtype=dot_dtype, out_dtype=out_dtype, **pf)


def matmul_swiglu(a, b_gate, b_up, *, out_dtype=None):
    """o = silu(A @ Bg) * (A @ Bu), single fused pass; A: [M, K]; Bg / Bu
    tensors or int8 dicts."""
    b_gate, g_scale = split_quantized(b_gate)
    b_up, u_scale = split_quantized(b_up)
    if _use_kernel(a):
        return _mm.matmul_swiglu(a, b_gate, b_up, out_dtype=out_dtype,
                                 bg_scale=g_scale, bu_scale=u_scale)
    return _ref.fused_matmul_swiglu_ref(a, b_gate, b_up, wg_scale=g_scale,
                                        wu_scale=u_scale,
                                        compute_dtype=a.dtype,
                                        out_dtype=out_dtype or a.dtype)


def fused_matmul_swiglu(x, wg, wu, *, prologue=None, residual=None,
                        compute_dtype=None, out_dtype=None):
    """y = silu(norm(x) @ wg) * (norm(x) @ wu) [+ residual];
    x: [..., K], wg / wu: [K, N] (or int8 dicts) -> [..., N].  As in
    `fused_matmul`, a normalized operand stays fp32 in the kernel; only an
    un-normalized x is cast to the compute dtype."""
    wg, g_scale = split_quantized(wg)
    wu, u_scale = split_quantized(wu)
    pf = _prologue_fields(prologue)
    if _use_kernel(x):
        lead = x.shape[:-1]
        K, N = x.shape[-1], wg.shape[-1]
        cd = compute_dtype or x.dtype
        x2 = x.reshape(-1, K)
        if prologue is None:
            x2 = x2.to(cd)
        res2 = residual.reshape(-1, N) if residual is not None else None
        out = _mm.matmul_swiglu(x2, _wcast(wg, g_scale, cd),
                                _wcast(wu, u_scale, cd), residual=res2,
                                out_dtype=out_dtype, bg_scale=g_scale,
                                bu_scale=u_scale, **pf)
        return out.reshape(*lead, N)
    return _ref.fused_matmul_swiglu_ref(
        x, wg, wu, wg_scale=g_scale, wu_scale=u_scale, residual=residual,
        compute_dtype=compute_dtype, out_dtype=out_dtype, **pf)


def residual_norm(x, y, params, kind: str):
    """Fused residual add + pre-norm: r = x + y; h = norm(r) in one pass —
    the sub-layer boundary a GEMM epilogue can't absorb (the sum is both
    the next residual and the norm input).  -> (h, r)."""
    if _use_kernel(x):
        if kind == "rmsnorm":
            return _norm.residual_rmsnorm(x, y, params["scale"])
        return _norm.residual_layernorm(x, y, params["scale"],
                                        params["bias"])
    return _ref.residual_norm_ref(
        x, y, norm=kind, gamma=params["scale"], nbeta=params.get("bias"),
        eps=RMS_EPS if kind == "rmsnorm" else LN_EPS)


# --------------------------------------------------------------------------
# normalization (the unfused chain)
# --------------------------------------------------------------------------

def rmsnorm(x, gamma, *, eps=RMS_EPS):
    if _use_kernel(x):
        return _norm.rmsnorm(x, gamma, eps=eps)
    return _ref.rmsnorm_ref(x, gamma, eps=eps)


def layernorm(x, gamma, beta, *, eps=LN_EPS):
    if _use_kernel(x):
        return _norm.layernorm(x, gamma, beta, eps=eps)
    return _ref.layernorm_ref(x, gamma, beta, eps=eps)


def norm(x, params, kind: str):
    """Dispatch on the config's norm kind; params: {"scale"[, "bias"]}."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# --------------------------------------------------------------------------
# Mamba2 SSD
# --------------------------------------------------------------------------

def ssd(x, dt, A, B, C, D, *, chunk=128):
    """x: [Bt, S, H, P] -> (y, h_final).  Chunked state-space-duality scan.

    The kernel takes any S.  `ref` mode repeats the reference's own
    dispatch off the TPU: `ssd_chunked_ref` at the largest chunk <= `chunk`
    that divides S (1 for a prime length)."""
    if _use_kernel(x):
        return _ssd.ssd(x, dt, A, B, C, D)
    return _ref.ssd_chunked_ref(x, dt, A, B, C, D,
                                chunk=_best_chunk(x.shape[1], chunk))


def _best_chunk(S: int, chunk: int) -> int:
    c = min(chunk, S)
    while S % c:
        c -= 1
    return max(c, 1)


def ssd_decode(x, dt, A, B, C, D, h):
    """Single-step SSD state update; the reference has no kernel here
    either (a few element-wise ops per state entry)."""
    return _ref.ssd_decode_ref(x, dt, A, B, C, D, h)

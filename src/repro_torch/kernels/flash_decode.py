"""Paged single-token decode attention: partials and normalized variants.

Replaces the TPU kernels `src/repro/kernels/flash_decode.py:
paged_decode_partials` (`_paged_partials_kernel`) and
`paged_decode_attention` (`_paged_decode_kernel`).  Both come from one CUDA
template, `csrc/paged_decode.cu`, whose note says what bounds them on an
H100 and how the design answers it.

`paged_decode_plain` is the kernels' arithmetic in plain PyTorch: per pool
block, fp32 scores q.k / sqrt(D), -1e30 masks, the online-softmax rescale,
P cast to V's dtype for P.V; table entries that are absent (< 0) or wholly
past the slot's length are skipped.  The wrappers launch the kernel for CUDA
tensors and take the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGTYPES = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P]
_ATTENTION_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths):
    """-> (o unnormalized fp32 [B, H, D], m [B, H], l [B, H])."""
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    G = H // KV
    MB = block_tables.shape[1]
    dev = q.device
    sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, KV, G, D)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    lengths = lengths.to(torch.int64)
    tok = torch.arange(BS, device=dev)
    for e in range(MB):
        t = block_tables[:, e].to(torch.int64)
        live = (t >= 0) & (e * BS < lengths)                      # [B]
        blk = torch.clamp(t, min=0)
        kb = k_pool[blk].float()                                  # [B,BS,KV,D]
        vb = v_pool[blk].float()
        s = torch.einsum("bkgd,bskd->bkgs", qf, kb) * sm_scale
        ok = (e * BS + tok)[None, :] < lengths[:, None]           # [B, BS]
        s = torch.where(ok[:, None, None], s,
                        torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p.to(v_pool.dtype).float(), vb)
        lv = live[:, None, None]
        m = torch.where(lv, m_new, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv[..., None], acc_new, acc)
    return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def _check(what, q, k_pool, v_pool, block_tables, lengths):
    build.require_cuda(what, q, k_pool, v_pool, block_tables, lengths)
    B, H, D = q.shape
    _, BS, KV, Dk = k_pool.shape
    if (Dk != D or v_pool.shape != k_pool.shape or H % KV or H // KV > 8
            or D % 4 or H // KV * D > 2048 or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype
            or block_tables.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(f"{what}: unsupported operands q {tuple(q.shape)} "
                         f"{q.dtype}, pools {tuple(k_pool.shape)} "
                         f"{k_pool.dtype}, tables {tuple(block_tables.shape)}")
    return (q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
            block_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())


def paged_decode_partials(q, k_pool, v_pool, block_tables, lengths):
    """q: [B, H, D]; k/v_pool: [NB, BS, KV, D]; block_tables: [B, MB]
    (< 0 absent); lengths: [B] -> (o fp32 [B, H, D] unnormalized, m [B, H],
    l [B, H])."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths)
    q, k_pool, v_pool, tab, ln = _check("paged_decode_partials", q, k_pool,
                                        v_pool, block_tables, lengths)
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    fn = build.bind("paged_decode", "repro_paged_decode_partials",
                    _PARTIALS_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tab.data_ptr(), ln.data_ptr(), o.data_ptr(), m.data_ptr(),
             l.data_ptr(), B, H, KV, D, BS, tab.shape[1],
             build.dtype_code(q), int(build.aligned16(k_pool)),
             1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, "paged_decode_partials launch")
    paged_decode_partials.launches += 1
    return o, m, l


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths):
    """As `paged_decode_partials`, normalized: -> [B, H, D] at q's dtype."""
    if q.device.type == "cpu":
        o, _, l = paged_decode_plain(q, k_pool, v_pool, block_tables,
                                     lengths)
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    q, k_pool, v_pool, tab, ln = _check("paged_decode_attention", q, k_pool,
                                        v_pool, block_tables, lengths)
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = build.bind("paged_decode", "repro_paged_decode_attention",
                    _ATTENTION_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             tab.data_ptr(), ln.data_ptr(), out.data_ptr(), B, H, KV, D, BS,
             tab.shape[1], build.dtype_code(q), int(build.aligned16(k_pool)),
             1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, "paged_decode_attention launch")
    paged_decode_attention.launches += 1
    return out


paged_decode_partials.launches = 0
paged_decode_attention.launches = 0

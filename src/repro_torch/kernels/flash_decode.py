"""Single-token decode attention: dense caches and block-paged pools.

Replaces the TPU kernels of `src/repro/kernels/flash_decode.py`:
`decode_attention` (`_decode_kernel`) over dense per-slot caches, through
`csrc/decode_attention.cu`, and `paged_decode_partials`
(`_paged_partials_kernel`) / `paged_decode_attention`
(`_paged_decode_kernel`) over the block pool, through one CUDA template,
`csrc/paged_decode.cu`.  Both sources fold KV positions with the same
online-softmax code (`csrc/common.cuh`); their notes say what bounds them on
an H100 and how the designs answer it.

The plain versions are the kernels' arithmetic in plain PyTorch: per chunk
(512 cache positions; one pool block), fp32 scores q.k / sqrt(D), -1e30
masks, the online-softmax rescale, P cast to V's dtype for P.V; chunks that
are wholly masked (dense), absent (< 0) or wholly past the slot's length
(paged) are skipped.  The wrappers launch the kernel for CUDA tensors and
take the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGTYPES = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P]
_ATTENTION_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]
_DENSE_ARGTYPES = [_P] * 8 + [_I] * 10 + [ctypes.c_float, _P]
DENSE_CHUNK = 512       # the TPU kernel's block_kv: positions per plain step
FOLD = 32               # positions per fold in csrc/decode_attention.cu
MAX_SPLITS = 64         # csrc/decode_attention.cu DA_MAX_SPLITS


def decode_attention_plain(q, k_cache, v_cache, length, *, window=0):
    """q: [B, H, D]; k/v_cache: [B, S, KV, D]; length: [B] valid positions
    (<= S) -> [B, H, D] at q's dtype.  The TPU kernel's walk: chunks of
    min(512, S) positions, masked at pos >= length and, for window > 0, at
    pos < length - window; wholly masked chunks skipped."""
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    dev = q.device
    chunk = min(DENSE_CHUNK, S)
    sm_scale = 1.0 / math.sqrt(D)
    length = length.to(torch.int64)
    qf = q.float().reshape(B, KV, G, D)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    for c0 in range(0, S, chunk):
        kb = k_cache[:, c0:c0 + chunk].float()                    # [B,n,KV,D]
        vb = v_cache[:, c0:c0 + chunk].float()
        pos = c0 + torch.arange(kb.shape[1], device=dev)
        ok = pos[None, :] < length[:, None]                       # [B, n]
        live = c0 < length                                        # [B]
        if window > 0:
            ok &= pos[None, :] >= (length - window)[:, None]
            live &= c0 + chunk > length - window
        s = torch.einsum("bkgd,bskd->bkgs", qf, kb) * sm_scale
        s = torch.where(ok[:, None, None], s,
                        torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), vb)
        lv = live[:, None, None]
        m = torch.where(lv, m_new, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv[..., None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_splits(B: int, KV: int, S: int, sms: int):
    """(nsplit, range): S cut into ranges of a multiple of FOLD positions,
    enough of them for two blocks per SM over the (KV, B) grid."""
    folds = -(-S // FOLD)
    want = max(1, min(-(-2 * sms // max(B * KV, 1)), folds, MAX_SPLITS))
    rng = -(-folds // want) * FOLD
    return -(-S // rng), rng


def decode_attention(q, k_cache, v_cache, length, *, window=0):
    """q: [B, H, D]; k/v_cache: [B, S, KV, D]; length: [B] valid positions
    (<= S); `window` > 0: only positions >= length - window attend.
    -> [B, H, D] at q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      window=window)
    build.require_cuda("decode_attention", q, k_cache, v_cache, length)
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape if k_cache.ndim == 4 else (0,) * 4
    if (k_cache.ndim != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D
            or length.shape != (B,)
            or v_cache.shape != k_cache.shape or KV < 1 or H % KV
            or H // KV > 8 or D % 4 or H // KV * D > 2048 or window < 0
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype):
        raise ValueError(f"decode_attention: unsupported operands q "
                         f"{tuple(q.shape)} {q.dtype}, caches "
                         f"{tuple(k_cache.shape)} {k_cache.dtype}, window "
                         f"{window}")
    q, k_cache, v_cache = (t.contiguous() for t in (q, k_cache, v_cache))
    ln = length.to(torch.int32).contiguous()
    nsplit, rng = dense_splits(B, KV, S, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    parts = (None, None, None)
    if nsplit > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        parts = (torch.empty((nsplit, B, H, D), **f32),
                 torch.empty((nsplit, B, H), **f32),
                 torch.empty((nsplit, B, H), **f32))
    fn = build.bind("decode_attention", "repro_decode_attention",
                    _DENSE_ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             ln.data_ptr(), out.data_ptr(),
             *(t.data_ptr() if t is not None else None for t in parts),
             B, H, KV, D, S, rng, nsplit, int(window), build.dtype_code(q),
             int(build.aligned16(k_cache)), 1.0 / math.sqrt(D),
             build.stream_of(q))
    build.check(err, "decode_attention launch")
    decode_attention.launches += 1
    return out


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


decode_attention.launches = 0
paged_decode_partials.launches = 0
paged_decode_attention.launches = 0

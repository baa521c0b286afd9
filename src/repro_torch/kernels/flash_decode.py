"""Single-token decode attention: dense caches and block-paged pools.

Replaces the TPU kernels of `src/repro/kernels/flash_decode.py`:
`decode_attention` (`_decode_kernel`) over dense per-slot caches, through
`csrc/decode_attention.cu`, and `paged_decode_partials`
(`_paged_partials_kernel`) / `paged_decode_attention`
(`_paged_decode_kernel`) over the block pool, through
`csrc/paged_decode.cu`.  Both fold through one stage ring,
`csrc/decode_fold.cuh`, over a grid (kv head, slot, split): the dense
kernel cuts the cache's positions into ranges (`dense_splits`,
`dense_range`), the paged kernel the table's entries (`paged_splits`,
`split_ranges`), and a merge kernel folds the splits' partials into the
normalized output (`paged_decode_merge` alone; the normalized wrappers
always run it, at one split too).  The sources' notes say what bounds them
on an H100 and how the design answers it.  The paged wrappers also take
int8 pools with their per-(block, kv head) fp32 scales `k_scale` /
`v_scale` [NB, KV] (the TPU kernels' `quantized` form).

The plain versions are the kernels' arithmetic in plain PyTorch: per chunk
of positions (dense: 512, the TPU kernel's walk, or with `splits` the
kernel's own 32-position stages in each split's range; paged: one pool
block), fp32 scores q.k / sqrt(D), -1e30 masks, the online-softmax
rescale, P cast to V's dtype for P.V; chunks that are wholly masked
(dense), absent (< 0) or wholly past the slot's length (paged) are
skipped; int8 pools: the page's scores times its k_scale after
1 / sqrt(D), P kept in fp32, the page's P.V times its v_scale.  A split is
the plain fold over its range, the splits merged by the online-softmax rule
(`paged_decode_merge_plain`).  The wrappers launch
the kernel for CUDA tensors and take the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_PARTIALS_ARGTYPES = [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P]
_ATTENTION_ARGTYPES = [_P] * 11 + [_I] * 9 + [ctypes.c_float, _P]
_DENSE_ARGTYPES = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]
_MERGE_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
MAX_MERGE_SPLITS = 64   # csrc/decode_fold.cuh DF_MAX_SPLITS
FOLD_THREADS = 256      # csrc/decode_fold.cuh DF_THREADS
MAX_HEADS = 16          # csrc/decode_fold.cuh DF_MAXG: query heads a kv head
STAGE = 32              # csrc/decode_fold.cuh DF_STAGE_TOKENS: dense stage
PAGED_MIN_ENTRIES = 4   # table entries a split of the paged grid spans
SPLIT_TOKENS = 512      # pool positions a split of a full table spans at most
DENSE_BLOCKS_PER_SM = 4  # blocks the dense split rule aims at per SM
SM_COUNT = 132          # H100 SXM: the split rule's SMs off the card
DENSE_CHUNK = 512       # the TPU kernel's block_kv: positions per plain step


def decode_attention_plain(q, k_cache, v_cache, length, *, window=0,
                           splits=None):
    """q: [B, H, D]; k/v_cache: [B, S, KV, D]; length: [B] valid positions
    (<= S) -> [B, H, D] at q's dtype.  The TPU kernel's walk: chunks of
    min(512, S) positions, masked at pos >= length and, for window > 0, at
    pos < length - window; wholly masked chunks skipped.  With `splits`,
    the kernel's walk: S cut into `splits` ranges of `dense_range(S,
    splits)` positions, each folded in STAGE-position chunks into fp32
    partials, merged by the online-softmax rule."""
    S = k_cache.shape[1]
    if splits is None:
        o, _, l = _dense_fold(q, k_cache, v_cache, length, window, 0, S,
                              min(DENSE_CHUNK, S))
        return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    rng = dense_range(S, splits)
    parts = [_dense_fold(q, k_cache, v_cache, length, window, z * rng,
                         min(S, (z + 1) * rng), STAGE) for z in range(splits)]
    o, m, l = (torch.stack(x) for x in zip(*parts))
    return paged_decode_merge_plain(o, m, l, out_dtype=q.dtype)


def _dense_fold(q, k_cache, v_cache, length, window, p0, p1, chunk):
    """The chunk-by-chunk fold over positions [p0, p1) in chunks of `chunk`
    from p0 -> (o unnormalized fp32 [B, H, D], m [B, H], l [B, H])."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    dev = q.device
    sm_scale = 1.0 / math.sqrt(D)
    length = length.to(torch.int64)
    qf = q.float().reshape(B, KV, G, D)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    for c0 in range(p0, p1, chunk):
        c1 = min(c0 + chunk, p1)
        kb = k_cache[:, c0:c1].float()                            # [B,n,KV,D]
        vb = v_cache[:, c0:c1].float()
        pos = torch.arange(c0, c1, device=dev)
        ok = pos[None, :] < length[:, None]                       # [B, n]
        live = c0 < length                                        # [B]
        if window > 0:
            ok &= pos[None, :] >= (length - window)[:, None]
            live &= c1 > length - window
        s = torch.einsum("bkgd,bskd->bkgs", qf, kb) * sm_scale
        s = s.masked_fill(~ok[:, None, None], NEG_INF)
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
    return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dense_splits(B: int, KV: int, S: int, sms: int = SM_COUNT, *,
                 window: int = 0) -> int:
    """Splits of the dense kernel's grid (KV, B, splits): S cut into ranges
    of whole STAGE-position stages (`dense_range`), short enough that the
    positions a slot can attend (S, or the window where it is shorter)
    cover DENSE_BLOCKS_PER_SM blocks an SM over the (KV, B) grid (each
    range rounded down to whole stages, so the count rounds up), at most
    MAX_MERGE_SPLITS."""
    stages = -(-S // STAGE)
    span = -(-min(S, window if window > 0 else S) // STAGE)
    want = max(1, min(-(-DENSE_BLOCKS_PER_SM * sms // max(B * KV, 1)), span,
                      MAX_MERGE_SPLITS))
    per = max(span // want, -(-stages // MAX_MERGE_SPLITS))
    return -(-stages // per)


def dense_range(S: int, splits: int) -> int:
    """Positions of each split's range [z * range, (z + 1) * range): whole
    STAGE-position stages, ceil(stages / splits) of them."""
    return -(-(-(-S // STAGE)) // splits) * STAGE


def decode_attention(q, k_cache, v_cache, length, *, window=0):
    """q: [B, H, D]; k/v_cache: [B, S, KV, D]; length: [B] valid positions
    (<= S); `window` > 0: only positions >= length - window attend.
    -> [B, H, D] at q's dtype.  The grid's split count is `dense_splits`
    for the device (the plain version for CPU tensors: the TPU kernel's
    walk)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      window=window)
    build.require_cuda("decode_attention", q, k_cache, v_cache, length)
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape if k_cache.ndim == 4 else (0,) * 4
    q, k_cache, v_cache = (t.contiguous() for t in (q, k_cache, v_cache))
    if KV and not _fold_shape_ok(H, KV, D, q.element_size()):
        raise ValueError(_shape_error("decode_attention", H, KV, D))
    if (k_cache.ndim != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D
            or length.shape != (B,) or v_cache.shape != k_cache.shape
            or window < 0
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype
            or not build.aligned16(k_cache, v_cache)):
        raise ValueError(f"decode_attention: unsupported operands q "
                         f"{tuple(q.shape)} {q.dtype}, caches "
                         f"{tuple(k_cache.shape)} {k_cache.dtype}, window "
                         f"{window}")
    ln = length.to(torch.int32).contiguous()
    splits = dense_splits(B, KV, S, _sm_count(q.device.index or 0),
                          window=window)
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (torch.empty((splits, B, H, D), **f32),
             torch.empty((splits, B, H), **f32),
             torch.empty((splits, B, H), **f32))
    fn = build.bind("decode_attention", "repro_decode_attention",
                    _DENSE_ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             ln.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in parts),
             B, H, KV, D, S, dense_range(S, splits), splits, int(window),
             build.dtype_code(q), 1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, "decode_attention launch")
    decode_attention.launches += 1
    return out


def sm_count(device) -> int:
    """SMs of a CUDA device; SM_COUNT for any other (the plain versions
    compute the same function whatever the split)."""
    if device.type != "cuda":
        return SM_COUNT
    return _sm_count(device.index or 0)


def paged_splits(B: int, KV: int, MB: int, *, sms: int = SM_COUNT,
                 at_least: int = 1) -> int:
    """Splits of the paged kernel's grid (KV, B, splits): at least
    `at_least`, and enough for two blocks per SM, each split spanning at
    least PAGED_MIN_ENTRIES table entries, at most MAX_MERGE_SPLITS."""
    want = max(at_least, -(-2 * sms // max(B * KV, 1)))
    cap = max(1, -(-MB // PAGED_MIN_ENTRIES))
    return max(1, min(want, max(cap, at_least), MAX_MERGE_SPLITS))


def paged_min_splits(MB: int, BS: int) -> int:
    """Splits a full table of MB entries of BS positions needs so that no
    split spans more than SPLIT_TOKENS positions, however few slots and
    kv heads the grid has: long tables spread over more blocks of the
    card.  A function of the table's shape alone, so a decode step's
    launches never depend on the live lengths."""
    return max(1, -(-MB * BS // SPLIT_TOKENS))


def split_ranges(MB: int, splits: int):
    """The contiguous table-entry range [e0, e1) of each split (the
    kernel's grid z: per = ceil(MB / splits) entries each)."""
    per = -(-MB // splits)
    return [(z * per, min(MB, (z + 1) * per)) for z in range(splits)]


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, splits=1,
                       *, k_scale=None, v_scale=None):
    """-> (o unnormalized fp32 [B, H, D], m [B, H], l [B, H]); with
    `splits` > 1, one set per split of the table (`split_ranges`):
    [splits, B, H, D] and [splits, B, H].  `k_scale` / `v_scale`: the
    scales of int8 pools."""
    sc = (k_scale, v_scale)
    if splits > 1:
        parts = [_paged_fold(q, k_pool, v_pool, block_tables, lengths, e0, e1,
                             *sc)
                 for e0, e1 in split_ranges(block_tables.shape[1], splits)]
        return tuple(torch.stack(x) for x in zip(*parts))
    return _paged_fold(q, k_pool, v_pool, block_tables, lengths, 0,
                       block_tables.shape[1], *sc)


def _paged_fold(q, k_pool, v_pool, block_tables, lengths, e0, e1,
                k_scale=None, v_scale=None):
    """The page-by-page fold over table entries [e0, e1) (int8 pools: each
    page's K and V scales; absent entries read block 0's, and their fold is
    dead)."""
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    G = H // KV
    dev = q.device
    sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, KV, G, D)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    lengths = lengths.to(torch.int64)
    tok = torch.arange(BS, device=dev)
    for e in range(e0, e1):
        t = block_tables[:, e].to(torch.int64)
        live = (t >= 0) & (e * BS < lengths)                      # [B]
        blk = torch.clamp(t, min=0)
        kb = k_pool[blk].float()                                  # [B,BS,KV,D]
        vb = v_pool[blk].float()
        s = torch.einsum("bkgd,bskd->bkgs", qf, kb) * sm_scale
        if k_scale is not None:
            s = s * k_scale[blk].float()[:, :, None, None]
        ok = (e * BS + tok)[None, :] < lengths[:, None]           # [B, BS]
        s = s.masked_fill(~ok[:, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        if v_scale is None:
            pv = torch.einsum("bkgs,bskd->bkgd", p.to(v_pool.dtype).float(),
                              vb)
        else:
            pv = (torch.einsum("bkgs,bskd->bkgd", p, vb)
                  * v_scale[blk].float()[:, :, None, None])
        acc_new = acc * corr[..., None] + pv
        lv = live[:, None, None]
        m = torch.where(lv, m_new, m)
        l = torch.where(lv, l_new, l)
        acc = torch.where(lv[..., None], acc_new, acc)
    return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def _fold_shape_ok(H, KV, D, esize) -> bool:
    """The stage ring's shapes (csrc/decode_fold.cuh df_shape_ok): at most
    MAX_HEADS = 16 query heads a kv head (the fold's two head capacities:
    8, one warp a head, and 16, two heads a warp, chatglm3's 32 / 2), G * D
    <= 2048 (four pairs of output dimensions a thread), rows of whole
    16-byte columns, twice their count dividing the block's
    FOLD_THREADS."""
    cols = D * esize // 16
    return (KV >= 1 and H % KV == 0 and H // KV <= MAX_HEADS
            and H // KV * D <= 2048 and (D * esize) % 16 == 0 and cols >= 1
            and FOLD_THREADS % (2 * cols) == 0)


def _shape_error(what, H, KV, D) -> str:
    """The part of a refusal that names the heads and width the fold does
    not take."""
    return (f"{what}: H {H} / KV {KV} at D {D} is outside the decode "
            f"fold's shapes (at most {MAX_HEADS} query heads a kv head, "
            f"G * D <= 2048, 16-byte rows)")


def _check(what, q, k_pool, v_pool, block_tables, lengths, k_scale=None,
           v_scale=None):
    """Raise on operands the kernel does not take: pools at q's dtype, or
    int8 pools with fp32-castable scales [NB, KV] each.  -> the operands
    laid out for the launch, scales as fp32 (None for unquantized pools)."""
    build.require_cuda(what, q, k_pool, v_pool, block_tables, lengths,
                       k_scale, v_scale)
    B, H, D = q.shape
    NB, BS, KV, Dk = k_pool.shape
    if not _fold_shape_ok(H, KV, D, k_pool.element_size()):
        raise ValueError(_shape_error(what, H, KV, D))
    int8 = k_pool.dtype == torch.int8
    pools_ok = (v_pool.dtype == k_pool.dtype
                and (k_scale is None) == (v_scale is None) == (not int8)
                and (k_pool.dtype == q.dtype or int8)
                and (not int8 or (k_scale.shape == v_scale.shape == (NB, KV)
                                  and q.dtype != torch.int8)))
    if (Dk != D or v_pool.shape != k_pool.shape or not pools_ok
            or block_tables.shape[0] != B or lengths.shape != (B,)
            or not build.aligned16(k_pool, v_pool)):
        raise ValueError(f"{what}: unsupported operands q {tuple(q.shape)} "
                         f"{q.dtype}, pools {tuple(k_pool.shape)} "
                         f"{k_pool.dtype}, tables {tuple(block_tables.shape)}"
                         f", scales {k_scale is not None}")
    if int8:
        k_scale = k_scale.float().contiguous()
        v_scale = v_scale.float().contiguous()
    return (q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
            k_scale, v_scale, block_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())



def paged_decode_partials(q, k_pool, v_pool, block_tables, lengths,
                          splits=1, *, k_scale=None, v_scale=None):
    """q: [B, H, D]; k/v_pool: [NB, BS, KV, D]; block_tables: [B, MB]
    (< 0 absent); lengths: [B] -> (o fp32 [B, H, D] unnormalized, m [B, H],
    l [B, H]); with `splits` > 1 the table's entries are cut into that many
    contiguous ranges (`split_ranges`), one grid slice each, and every
    output gains a leading [splits] dimension.  Int8 pools take their
    [NB, KV] fp32 scales `k_scale` / `v_scale`."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths,
                                  splits, k_scale=k_scale, v_scale=v_scale)
    q, k_pool, v_pool, ks, vs, tab, ln = _check(
        "paged_decode_partials", q, k_pool, v_pool, block_tables, lengths,
        k_scale, v_scale)
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    lead = (splits,) if splits > 1 else ()
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty((*lead, B, H, D), **f32)
    m = torch.empty((*lead, B, H), **f32)
    l = torch.empty((*lead, B, H), **f32)
    fn = build.bind("paged_decode", "repro_paged_decode_partials",
                    _PARTIALS_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), build.ptr(ks),
             build.ptr(vs), tab.data_ptr(), ln.data_ptr(), o.data_ptr(),
             m.data_ptr(), l.data_ptr(), B, H, KV, D, BS, tab.shape[1],
             int(splits), build.dtype_code(k_pool), build.dtype_code(q),
             1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, "paged_decode_partials launch")
    _count(paged_decode_partials, k_pool)
    return o, m, l


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None):
    """As `paged_decode_partials`, normalized: -> [B, H, D] at q's dtype.
    The grid splits the table as `paged_splits` says for the device, at
    least `paged_min_splits` of the table (one split or more), and the same
    call merges the splits (the plain version likewise).  The split count
    depends on the operands' shapes alone: the one paged route of a decode
    step."""
    if q.device.type == "cpu":
        MB = block_tables.shape[1]
        S = paged_splits(q.shape[0], k_pool.shape[2], MB,
                         sms=sm_count(q.device),
                         at_least=paged_min_splits(MB, k_pool.shape[1]))
        o, m, l = paged_decode_plain(q, k_pool, v_pool, block_tables,
                                     lengths, S, k_scale=k_scale,
                                     v_scale=v_scale)
        if S == 1:
            o, m, l = o[None], m[None], l[None]
        return paged_decode_merge_plain(o, m, l, out_dtype=q.dtype)
    q, k_pool, v_pool, ks, vs, tab, ln = _check(
        "paged_decode_attention", q, k_pool, v_pool, block_tables, lengths,
        k_scale, v_scale)
    B, H, D = q.shape
    _, BS, KV, _ = k_pool.shape
    S = paged_splits(B, KV, tab.shape[1], sms=sm_count(q.device),
                     at_least=paged_min_splits(tab.shape[1], BS))
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (torch.empty((S, B, H, D), **f32),
             torch.empty((S, B, H), **f32), torch.empty((S, B, H), **f32))
    fn = build.bind("paged_decode", "repro_paged_decode_attention",
                    _ATTENTION_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), build.ptr(ks),
             build.ptr(vs), tab.data_ptr(), ln.data_ptr(), out.data_ptr(),
             *(t.data_ptr() for t in parts),
             B, H, KV, D, BS, tab.shape[1], S, build.dtype_code(k_pool),
             build.dtype_code(q), 1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, "paged_decode_attention launch")
    _count(paged_decode_attention, k_pool)
    return out


def paged_decode_merge_plain(o, m, l, *, out_dtype):
    """The online-softmax merge of split partials o [S, B, H, D], m, l
    [S, B, H] -> [B, H, D] at `out_dtype`: sum_s o_s e^(m_s - m) /
    max(sum_s l_s e^(m_s - m), 1e-30), m = max_s m_s."""
    m_all = m.amax(dim=0, keepdim=True)
    corr = torch.exp(m - m_all)
    l_all = (l * corr).sum(dim=0)
    o_all = (o * corr[..., None]).sum(dim=0)
    return (o_all / torch.clamp(l_all, min=1e-30)[..., None]).to(out_dtype)


def paged_decode_merge(o, m, l, *, out_dtype):
    """Merge `paged_decode_partials`' split partials (o [S, B, H, D], m, l
    [S, B, H], fp32) into the normalized output [B, H, D] at `out_dtype`:
    one launch of the second kernel of `csrc/paged_decode.cu`."""
    if o.device.type == "cpu":
        return paged_decode_merge_plain(o, m, l, out_dtype=out_dtype)
    build.require_cuda("paged_decode_merge", o, m, l)
    S, B, H, D = o.shape if o.ndim == 4 else (0,) * 4
    if (o.ndim != 4 or m.shape != (S, B, H) or l.shape != m.shape
            or not 1 <= S <= MAX_MERGE_SPLITS
            or any(t.dtype != torch.float32 for t in (o, m, l))):
        raise ValueError(f"paged_decode_merge: unsupported partials o "
                         f"{tuple(o.shape)}, m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}")
    o, m, l = o.contiguous(), m.contiguous(), l.contiguous()
    out = torch.empty((B, H, D), dtype=out_dtype, device=o.device)
    fn = build.bind("paged_decode", "repro_paged_decode_merge",
                    _MERGE_ARGTYPES)
    err = fn(o.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), B, H,
             D, S, build.dtype_code(out), build.stream_of(o))
    build.check(err, "paged_decode_merge launch")
    paged_decode_merge.launches += 1
    return out


def _count(wrapper, k_pool) -> None:
    wrapper.launches += 1
    wrapper.launches_by[POOL_FORMS[k_pool.dtype]] += 1


# the paged wrappers' launch counts by pool form
POOL_FORMS = {torch.bfloat16: "bf16", torch.float32: "fp32",
              torch.int8: "int8"}
decode_attention.launches = 0
paged_decode_partials.launches = 0
paged_decode_attention.launches = 0
paged_decode_merge.launches = 0
for _w in (paged_decode_partials, paged_decode_attention):
    _w.launches_by = dict.fromkeys(POOL_FORMS.values(), 0)

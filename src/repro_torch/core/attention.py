"""Multi-head attention on one device (port of the reference's
core/attention.py, unsharded route).

Prefill (`attn_full`) is the reference's `tp == 1` route `_attn_seq_sp` with
no sequence shards: Q/K/V projections (norm prologue fused), rotary
positions, flash attention with the static offset 0, out-projection with the
residual fused into its epilogue.  Decode writes the new token's K/V in
place and attends: `attn_decode_paged` against the block pools (full-context
layers), `attn_decode` against a dense per-slot cache [B, W, KV, hd] — the
ring cache of a sliding-window layer whose window W is shorter than max_seq
(slot = position % W), or a linear cache.

Paged pools are [NB + 1, BS, KV, hd]: the trailing block is a write sink
that absorbs the writes the reference drops (`mode="drop"`) — absent table
entries — so the in-place scatter needs no host round trip.  The block
allocator never hands it out.  Int8 pools (`kv_dtype="int8"`) carry fp32
scales "ks" / "vs" [NB + 1, KV], one a block and kv head, sink row
included, and quantize on write (`_append_quantized`).
"""
from __future__ import annotations

import torch

from repro_torch.core.nn import act_dtype, fused_pdot, pdot
from repro_torch.core.precision import Policy
from repro_torch.core.rope import apply_rope
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import Epilogue

SCALE_EPS = 1e-30      # guards zero-amax blocks and unwritten scale slots
# the reference quantizes the pools inside jitted programs, where XLA
# turns the division by 127 into a product with the fp32 reciprocal; the
# port takes the same product, so that its scales are the reference's bit
# for bit (`quantize_int8_axiswise`, run eagerly there, divides)
INV_127 = 1.0 / 127.0


def kv_scale(amax):
    """The int8 pools' scale of a block and kv head from its amax."""
    return torch.clamp(amax, min=SCALE_EPS) * INV_127


def attention_param_shapes(cfg) -> dict:
    E, H, hd, KV = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    return {"wq": (E, H * hd), "wk": (E, KV * hd),
            "wv": (E, KV * hd), "wo": (H * hd, E)}


def ring_from_full(k_full, window: int):
    """Arrange the last `window` positions of [B, S, KV, hd] into ring-buffer
    order (slot = pos % window).  S < window pads at the tail (masked by pos
    validity at decode)."""
    S = k_full.shape[1]
    if S >= window:
        return torch.roll(k_full[:, S - window:], shifts=S % window, dims=1)
    return torch.nn.functional.pad(k_full, (0, 0, 0, 0, 0, window - S))


def build_cache(k_full, v_full, *, cache_len: int, window: int = 0,
                dtype):
    """-> {"k", "v"} at `dtype`: window > 0, a ring cache of `window` slots
    [B, window, KV, hd]; else [B, cache_len, KV, hd] in position order,
    padded with zeros past the sequence."""
    S = k_full.shape[1]
    if window > 0:
        k_full = ring_from_full(k_full, window)
        v_full = ring_from_full(v_full, window)
    elif S < cache_len:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        k_full = torch.nn.functional.pad(k_full, pad)
        v_full = torch.nn.functional.pad(v_full, pad)
    return {"k": k_full.to(dtype), "v": v_full.to(dtype)}


def attn_full(p, x, *, cfg, policy: Policy, causal: bool, window: int = 0,
              with_cache: bool = False, cache_len: int = 0,
              cache_window: int = 0, norm=None, residual=None):
    """x: [B, S, E] -> (y [B, S, E], cache | None).  `cache_window` > 0:
    the cache is a ring of that many slots (else `cache_len` rows in
    position order), stored at the activation dtype (bf16 caches under the
    bf16 policy, fp32 under fp32).  `norm`: fused pre-norm prologue on the
    Q/K/V GEMMs (x arrives un-normalized); `residual`:
    folded into the out-projection epilogue, and y is then the updated
    residual stream."""
    B, S, E = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ad = act_dtype(policy)
    positions = torch.arange(S, device=x.device)

    q = fused_pdot(x, p["wq"], policy, prologue=norm).reshape(B, S, H, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)
    k = fused_pdot(x, p["wk"], policy, prologue=norm).reshape(B, S, KV, hd)
    v = fused_pdot(x, p["wv"], policy, prologue=norm).reshape(B, S, KV, hd)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)

    out = ops.flash_attention(q.to(ad), k.to(ad), v.to(ad), causal=causal,
                              window=window, q_offset=0)
    o = out.reshape(B, S, H * hd)
    if residual is not None:
        y = fused_pdot(o, p["wo"], policy,
                       epilogue=Epilogue(residual=residual, out_dtype=ad))
    else:
        y = pdot(o, p["wo"], policy)
    cache = (build_cache(k, v, cache_len=cache_len, window=cache_window,
                         dtype=ad) if with_cache else None)
    return y, cache


def _decode_q(p, x, pos, *, cfg, policy: Policy, norm=None):
    """Projected + rotated query for one decode step: [B, H, hd]."""
    B = x.shape[0]
    q = fused_pdot(x, p["wq"], policy, prologue=norm).reshape(
        B, cfg.n_heads, cfg.head_dim)
    return apply_rope(q[:, None], pos[:, None], theta=cfg.rope_theta,
                      fraction=cfg.rope_fraction)[:, 0]


def _decode_kv_new(p, x, pos, *, cfg, policy: Policy, norm=None):
    """This step's K/V rows ([B, KV, hd] each; K rotated)."""
    B = x.shape[0]
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = fused_pdot(x, p["wk"], policy, prologue=norm).reshape(B, KV, hd)
    v = fused_pdot(x, p["wv"], policy, prologue=norm).reshape(B, KV, hd)
    k = apply_rope(k[:, None], pos[:, None], theta=cfg.rope_theta,
                   fraction=cfg.rope_fraction)[:, 0]
    return k, v


def _decode_out_proj(p, merged, *, policy: Policy, residual=None):
    """[B, H*hd] head tensor @ wo -> [B, E] at the activation dtype; with
    `residual` the result is the updated residual stream."""
    ad = act_dtype(policy)
    o = merged.to(ad)
    if residual is not None:
        return fused_pdot(o, p["wo"], policy,
                          epilogue=Epilogue(residual=residual, out_dtype=ad),
                          out_dtype=torch.float32)
    return pdot(o, p["wo"], policy, out_dtype=torch.float32).to(ad)


def _quantized_kv(cache) -> bool:
    """True when the paged pools store int8 K / V with per-block-per-head
    fp32 scales ("ks" / "vs" [NB + 1, KV] beside "k" / "v")."""
    return "ks" in cache


def _append_quantized(pools, scales, x_new, blk, off, owned):
    """Quantize-on-write of one token a row into int8 pools [NB + 1, BS,
    KV, hd] (K and V: `pools`, with their scales [NB + 1, KV], `scales`),
    in place: the reference's `_append_quantized` for each pool, the pools
    quantized together to halve the step's launches.  x_new: the new rows
    [B, KV, hd], one a pool; blk [B] pool block (the sink for rows that
    own no block: `owned` False); off [B] in-block offset.  Blocks fill
    front to back, so a token at offset 0 is its block's first (re)use:
    it sets the block's scale from its own amax (which resets a reused
    block's stale scale).  Later offsets reuse the stored scale and clip;
    entries already in a block never move.

    Pure device work with a fixed launch sequence (no host index, no branch
    on whether a row is fresh), so a CUDA graph can hold it: the rows that
    write no scale (not fresh, or not owned) and the K / V of rows that own
    no block go to the sink as zeros, so that its duplicate writes agree."""
    xf = torch.stack(x_new).float()                          # [P, B, KV, hd]
    s_new = kv_scale(xf.abs().amax(-1))                       # [P, B, KV]
    fresh = off == 0
    s_old = torch.stack([sc[blk] for sc in scales])
    s = torch.where(fresh[:, None], s_new, torch.clamp(s_old, min=SCALE_EPS))
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    q = torch.where(owned[:, None, None], q, 0).to(torch.int8)
    write = fresh & owned
    slot = torch.where(write, blk, pools[0].shape[0] - 1)
    s_write = torch.where(write[:, None], s_new, 0)
    for i, (pool, sc) in enumerate(zip(pools, scales)):
        pool[blk, off] = q[i]
        sc[slot] = s_write[i]


def attn_decode_paged(p, x, pos, cache, block_tables, *, cfg,
                      policy: Policy, norm=None, residual=None):
    """One decode step against the block-paged KV pools.

    x: [B, E]; pos: [B] position of the token being written; cache:
    {"k", "v"} pools [NB + 1, BS, KV, hd] (trailing sink block), and for
    int8 pools their scales {"ks", "vs"} [NB + 1, KV]; block_tables:
    [B, MB] pool indices (< 0 unallocated).  The new token's K/V is written
    IN PLACE into block table[pos // BS] at offset pos % BS (absent blocks
    go to the sink; int8 pools quantize it, `_append_quantized`), then
    attention runs over length pos + 1 through the one paged route,
    `ops.paged_decode_attention`, whose split count depends on the shapes
    alone.  Returns (y [B, E], cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    ad = act_dtype(policy)
    k_pool, v_pool = cache["k"], cache["v"]
    sink = k_pool.shape[0] - 1
    BS, KV = k_pool.shape[1], k_pool.shape[2]
    MB = block_tables.shape[1]

    q = _decode_q(p, x, pos, cfg=cfg, policy=policy, norm=norm)
    k_new, v_new = _decode_kv_new(p, x, pos, cfg=cfg, policy=policy,
                                  norm=norm)

    pos = pos.to(torch.int64)
    entry = torch.clamp(pos // BS, max=MB - 1)
    gb = block_tables.to(torch.int64).gather(1, entry[:, None])[:, 0]
    owned = (gb >= 0) & (gb < sink) & (pos // BS < MB)
    if _quantized_kv(cache):
        _append_quantized((k_pool, v_pool), (cache["ks"], cache["vs"]),
                          (k_new, v_new), torch.where(owned, gb, sink),
                          torch.where(owned, pos % BS, 0), owned)
    else:
        flat = torch.where(owned, gb * BS + pos % BS,
                           torch.full_like(gb, sink * BS))
        k_pool.view(-1, KV, hd)[flat] = k_new.to(k_pool.dtype)
        v_pool.view(-1, KV, hd)[flat] = v_new.to(v_pool.dtype)

    length = (pos + 1).to(torch.int32)
    tab = torch.where((block_tables >= 0) & (block_tables < sink),
                      block_tables, torch.full_like(block_tables, -1))
    out = ops.paged_decode_attention(q.to(ad), k_pool, v_pool,
                                     tab.to(torch.int32), length,
                                     k_scale=cache.get("ks"),
                                     v_scale=cache.get("vs"))
    merged = out.reshape(B, H * hd)
    return _decode_out_proj(p, merged, policy=policy,
                            residual=residual), cache


def attn_decode(p, x, pos, cache, *, cfg, policy: Policy, window: int,
                norm=None, residual=None):
    """One decode step against a dense per-slot cache.

    x: [B, E]; pos: [B] position of the token being written; cache: {"k",
    "v"} [B, W, KV, hd].  A window layer whose cache holds exactly `window`
    slots is a ring: the new K/V goes IN PLACE to slot pos % W, and the
    valid slots are the prefix s < min(pos + 1, W) (slot s holds position
    pos - ((pos - s) mod W)); softmax does not depend on slot order, so that
    prefix is all the kernel needs.  Otherwise the cache is linear (pos <
    W): slot pos, and positions (pos - window, pos] attend.  As in the
    reference, the cache's shape picks the branch; every dense cache the
    port builds is a ring (`blocks._attn_decode` asserts it), and only the
    tests reach the linear branch, which mirrors the reference's mask.
    Returns (y [B, E], cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    ad = act_dtype(policy)
    k_cache, v_cache = cache["k"], cache["v"]
    W = k_cache.shape[1]
    ring = window > 0 and W == window

    q = _decode_q(p, x, pos, cfg=cfg, policy=policy, norm=norm)
    k_new, v_new = _decode_kv_new(p, x, pos, cfg=cfg, policy=policy,
                                  norm=norm)
    pos = pos.to(torch.int64)
    rows = torch.arange(B, device=x.device)
    if ring:
        slot, length, win = pos % W, torch.clamp(pos + 1, max=W), 0
    else:
        slot, length, win = pos, pos + 1, window
    k_cache[rows, slot] = k_new.to(k_cache.dtype)
    v_cache[rows, slot] = v_new.to(v_cache.dtype)

    # the caches join at the activation dtype, as the reference casts them
    # to q's (a no-op under bf16)
    out = ops.decode_attention(q.to(ad), k_cache.to(ad), v_cache.to(ad),
                               length.to(torch.int32), window=win)
    merged = out.reshape(B, H * hd)
    return _decode_out_proj(p, merged, policy=policy,
                            residual=residual), cache

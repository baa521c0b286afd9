"""Blocks of the kinds the port serves (port of the reference's
core/blocks.py, single device), fused (norm prologues and residual
epilogues inside the GEMMs, add + norm in one pass where no GEMM can absorb
it) or unfused (the discrete norm -> GEMM -> add chain):

  ``attn``          pre-norm attention + dense MLP
  ``local``         the same with sliding-window attention
  ``ssm``           pre-norm Mamba2 SSD block (attention-free, no MLP)
  ``hybrid_attn``   attention and SSM heads in parallel on one normalized
                    input, outputs averaged, then a dense MLP
  ``hybrid_local``  the same with sliding-window attention
  ``moe``           pre-norm attention + a Mixture-of-Experts FFN
                    (`mlp.moe_full` / `moe_decode`); fused, the attention
                    output skips the residual epilogue and one
                    `ops.residual_norm` pass does the add and ln2, since no
                    GEMM epilogue can absorb the experts' dispatch
  ``moe_local``     the same with sliding-window attention
  ``vit``           the ``attn`` block with bidirectional attention (the
                    paper's encoder-only topology): full-sequence passes
                    only, no decode step
  ``enc``           the same, an encoder-decoder's encoder layer (whisper)
  ``dec``           an encoder-decoder's decoder layer: causal
                    self-attention, then cross-attention over the encoder's
                    output (`memory`) behind its own norm ``lnx``, then the
                    MLP; with a cache it keeps the memory's K / V as
                    ``ck`` / ``cv`` [B, Sm, KV, hd] beside its self-attention
                    K / V, and a decode step attends them (`memory_len`
                    rows) without writing

Full-context attention layers keep their KV in the block pool
(`kind_paged`) and can prefill in chunks (`block_chunk`); a window shorter
than max_seq keeps a dense per-slot ring cache of `window` slots instead.
A ``dec`` layer's cross cache is dense and per slot under every layout."""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ATTN_KINDS, LOCAL_KINDS, MOE_KINDS,
                                     SSM_KINDS)
from repro_torch.core import attention as attn
from repro_torch.core import mlp as mlp_mod
from repro_torch.core import ssm as ssm_mod
from repro_torch.kernels import ops

PORTED_KINDS = ("attn", "local", "ssm", "hybrid_attn", "hybrid_local",
                "moe", "moe_local", "vit", "enc", "dec")
HYBRID_KINDS = ("hybrid_attn", "hybrid_local")
BIDIR_KINDS = ("enc", "vit")
SSM_STATE = ("h", "cx", "cbc")


def _require_ported(kind: str):
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the port runs "
                         f"{PORTED_KINDS}")


def norm_shapes(cfg):
    E = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": (E,)}
    return {"scale": (E,), "bias": (E,)}


def init_norm(cfg, dtype, device, count=None):
    lead = () if count is None else (count,)
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=device)
    return p


def block_param_shapes(kind: str, cfg) -> dict:
    _require_ported(kind)
    out = {"ln1": norm_shapes(cfg)}
    if kind in ATTN_KINDS:
        out["attn"] = attn.attention_param_shapes(cfg)
    if kind in SSM_KINDS:
        out["ssm"] = ssm_mod.ssm_param_shapes(cfg)
    if kind == "dec":
        out["lnx"] = norm_shapes(cfg)
        out["xattn"] = attn.attention_param_shapes(cfg)
    if kind in MOE_KINDS:
        out["ln2"] = norm_shapes(cfg)
        out["moe"] = mlp_mod.moe_param_shapes(cfg)
    elif kind != "ssm":
        out["ln2"] = norm_shapes(cfg)
        out["mlp"] = mlp_mod.mlp_param_shapes(cfg)
    return out


def _init_normal(generator, shapes, dtype, device, count):
    out = {}
    for name, shape in shapes.items():
        w = torch.empty((count,) + shape, dtype=dtype, device=device)
        for i in range(count):
            w[i] = torch.randn(shape, generator=generator,
                               device=device) * 0.02
        out[name] = w
    return out


def init_block(generator, kind: str, cfg, dtype, device, count: int):
    """`count` stacked layers of `kind` (leading layer dim), drawn layer by
    layer from `generator`: N(0, 0.02) attention (and cross-attention) /
    MLP / router and expert weights, unit norms, SSM leaves as
    `ssm.init_ssm` draws them."""
    _require_ported(kind)
    out = {"ln1": init_norm(cfg, dtype, device, count)}
    if kind in ATTN_KINDS:
        out["attn"] = _init_normal(generator, attn.attention_param_shapes(cfg),
                                   dtype, device, count)
    if kind in SSM_KINDS:
        layers = [ssm_mod.init_ssm(generator, cfg, dtype, device)
                  for _ in range(count)]
        out["ssm"] = {k: torch.stack([lp[k] for lp in layers])
                      for k in layers[0]}
    if kind == "dec":
        out["lnx"] = init_norm(cfg, dtype, device, count)
        out["xattn"] = _init_normal(generator,
                                    attn.attention_param_shapes(cfg), dtype,
                                    device, count)
    if kind in MOE_KINDS:
        out["ln2"] = init_norm(cfg, dtype, device, count)
        out["moe"] = _init_normal(generator, mlp_mod.moe_param_shapes(cfg),
                                  dtype, device, count)
    elif kind != "ssm":
        out["ln2"] = init_norm(cfg, dtype, device, count)
        out["mlp"] = _init_normal(generator, mlp_mod.mlp_param_shapes(cfg),
                                  dtype, device, count)
    return out


# --------------------------------------------------------------------------
# static per-kind attention attributes
# --------------------------------------------------------------------------

def kind_window(kind: str, cfg) -> int:
    return cfg.sliding_window if kind in LOCAL_KINDS else 0


def kind_causal(kind: str, cfg) -> bool:
    if kind in BIDIR_KINDS:
        return False
    return cfg.causal


def kind_cache_len(kind: str, cfg, max_seq: int) -> int:
    """KV-cache slots for this kind (ring caches: the window)."""
    w = kind_window(kind, cfg)
    return min(w, max_seq) if 0 < w < max_seq else max_seq


def kind_paged(kind: str, cfg, max_seq: int) -> bool:
    """Full-context attention layers keep their KV in the block pool; a
    window shorter than max_seq keeps a dense per-slot ring cache."""
    return kind in ATTN_KINDS and kind_cache_len(kind, cfg, max_seq) == max_seq


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _store_state(cache, new):
    """Write a decode step's SSM state into this layer's cache views (the
    stacked cache leaves are updated in place)."""
    for k in SSM_STATE:
        cache[k].copy_(new[k])


def _moe_boundary(x, y, p, *, cfg, fused):
    """The ln2 boundary of an MoE block, attention output y pending:
    -> (h2 = ln2(x + y), x + y).  Fused, one `ops.residual_norm` pass (no
    GEMM epilogue can absorb the experts' dispatch); unfused, the add and
    the norm."""
    if fused:
        return ops.residual_norm(x, y, p["ln2"], cfg.norm)
    x = x + y
    return ops.norm(x, p["ln2"], cfg.norm), x


def _cross_full(p, x, y, memory, *, cfg, policy, fused, with_cache):
    """A ``dec`` layer's cross-attention sub-layer after its
    self-attention (output y, pending unless None: the fused chain has
    already added it): -> (x', cross cache or None).  K / V come from the
    un-normalized `memory`; fused, lnx folds into the Q projection and the
    residual into the out-projection's epilogue."""
    kw = dict(cfg=cfg, policy=policy, causal=False, window=0,
              with_cache=with_cache, cache_len=memory.shape[1],
              memory=memory)
    if fused:
        x, xkv = attn.attn_full(p["xattn"], x, norm=ops.norm_prologue(
            p["lnx"], cfg.norm), residual=x, **kw)
    else:
        x = x + y
        yx, xkv = attn.attn_full(p["xattn"], ops.norm(x, p["lnx"], cfg.norm),
                                 **kw)
        x = x + yx
    return x, ({"ck": xkv["k"], "cv": xkv["v"]} if with_cache else None)


def block_full(kind: str, p, x, *, cfg, policy, fused: bool = True,
               with_cache: bool = False, max_seq: int = 0,
               compact_kv: bool = False, memory=None):
    """x: [B, S, E] -> (x', cache | None).  A paged layer's KV cache has
    `max_seq` rows, or with `compact_kv` the sequence's own length (paged
    admission scatters it into pool blocks); a ring layer's is always its
    `window` slots, so that admission overwrites the whole slot row.
    `memory` [B, Sm, E]: the encoder's output, which a ``dec`` layer's
    cross-attention reads (its cache then holds ck / cv at Sm rows)."""
    _require_ported(kind)
    if kind == "dec" and memory is None:
        raise ValueError("a dec layer needs the encoder's memory")
    if kind == "ssm":
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, sc = ssm_mod.ssm_full(p["ssm"], h, cfg=cfg, policy=policy,
                                 with_cache=with_cache)
        return x + y, sc
    causal = kind_causal(kind, cfg)
    window = kind_window(kind, cfg)
    cache_len = cache_window = 0
    if with_cache and kind_paged(kind, cfg, max_seq):
        cache_len = x.shape[1] if compact_kv else max_seq
    elif with_cache:
        cache_len = cache_window = kind_cache_len(kind, cfg, max_seq)
    kv_kw = dict(causal=causal, window=window, with_cache=with_cache,
                 cache_len=cache_len, cache_window=cache_window)
    hybrid = kind in HYBRID_KINDS
    moe = kind in MOE_KINDS
    if fused and moe:
        # keep the sub-layer output: its residual add fuses with ln2 below
        y, kv = attn.attn_full(p["attn"], x, cfg=cfg, policy=policy,
                               norm=ops.norm_prologue(p["ln1"], cfg.norm),
                               **kv_kw)
    elif fused and not hybrid:
        x, kv = attn.attn_full(p["attn"], x, cfg=cfg, policy=policy,
                               norm=ops.norm_prologue(p["ln1"], cfg.norm),
                               residual=x, **kv_kw)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, kv = attn.attn_full(p["attn"], h, cfg=cfg, policy=policy,
                               **kv_kw)
    cache = dict(kv) if with_cache else None
    if hybrid:
        s, sc = ssm_mod.ssm_full(p["ssm"], h, cfg=cfg, policy=policy,
                                 with_cache=with_cache)
        y = (y + s) * 0.5
        if with_cache:
            cache.update(sc)
    if kind == "dec":
        x, xc = _cross_full(p, x, None if fused else y, memory, cfg=cfg,
                            policy=policy, fused=fused,
                            with_cache=with_cache)
        if with_cache:
            cache.update(xc)
        y = None                    # the self-attention output is in x
    if moe:
        h2, x = _moe_boundary(x, y, p, cfg=cfg, fused=fused)
        x = x + mlp_mod.moe_full(p["moe"], h2, cfg=cfg, policy=policy,
                                 fused=fused)
    elif fused and hybrid:
        h2, x = ops.residual_norm(x, y, p["ln2"], cfg.norm)
        x = mlp_mod.mlp_full(p["mlp"], h2, cfg=cfg, policy=policy,
                             residual=x)
    elif fused:
        x = mlp_mod.mlp_full(p["mlp"], x, cfg=cfg, policy=policy,
                             norm=ops.norm_prologue(p["ln2"], cfg.norm),
                             residual=x)
    else:
        if y is not None:
            x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_full(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, cache


def block_chunk(kind: str, p, x, pos0, chunk_len, cache, block_tables, *,
                cfg, policy, fused: bool = True, rope_pos=None,
                tree_mask=None):
    """One chunked-prefill piece through a block whose KV is paged.

    x: [B, C, E], C consecutive prompt tokens from absolute position `pos0`
    [B] (`chunk_len` [B] of them real); cache: this layer's pool views,
    written in place.  Only full-context attention kinds chunk (their KV
    lives in the pool, which carries the chunk state between engine
    steps); SSM, ring, bidirectional and cross-attention kinds raise.
    The MLP (or the MoE FFN) runs the decode path on the flattened
    [B * C, E] rows, which all route and take capacity; only attention
    needs the chunk structure.
    -> (x', cache).

    `rope_pos` / `tree_mask` go to `attn_chunk_paged` for tree-speculative
    verify (rotation at each node's depth, the ancestor mask); both None on
    the chunked-prefill path."""
    _require_ported(kind)
    if (kind not in ATTN_KINDS or kind in SSM_KINDS or kind in BIDIR_KINDS
            or kind == "dec"):
        raise ValueError(f"chunked prefill unsupported for kind {kind!r}")
    B, C, E = x.shape
    kv_in = {k: cache[k] for k in ("k", "v", "ks", "vs") if k in cache}
    kw = dict(cfg=cfg, policy=policy, rope_pos=rope_pos,
              tree_mask=tree_mask)
    if kind in MOE_KINDS:
        if fused:
            y, _ = attn.attn_chunk_paged(
                p["attn"], x, pos0, chunk_len, kv_in, block_tables,
                norm=ops.norm_prologue(p["ln1"], cfg.norm), **kw)
        else:
            y, _ = attn.attn_chunk_paged(p["attn"],
                                         ops.norm(x, p["ln1"], cfg.norm),
                                         pos0, chunk_len, kv_in,
                                         block_tables, **kw)
        h2, x = _moe_boundary(x, y, p, cfg=cfg, fused=fused)
        y2 = mlp_mod.moe_decode(p["moe"], h2.reshape(B * C, E), cfg=cfg,
                                policy=policy, fused=fused)
        return x + y2.reshape(B, C, E), cache
    if fused:
        x, _ = attn.attn_chunk_paged(p["attn"], x, pos0, chunk_len, kv_in,
                                     block_tables,
                                     norm=ops.norm_prologue(p["ln1"],
                                                            cfg.norm),
                                     residual=x, **kw)
        x = mlp_mod.mlp_decode(p["mlp"], x.reshape(B * C, E), cfg=cfg,
                               policy=policy,
                               norm=ops.norm_prologue(p["ln2"], cfg.norm),
                               residual=x.reshape(B * C, E))
        return x.reshape(B, C, E), cache
    h = ops.norm(x, p["ln1"], cfg.norm)
    y, _ = attn.attn_chunk_paged(p["attn"], h, pos0, chunk_len, kv_in,
                                 block_tables, **kw)
    x = x + y
    h2 = ops.norm(x, p["ln2"], cfg.norm).reshape(B * C, E)
    y2 = mlp_mod.mlp_decode(p["mlp"], h2, cfg=cfg, policy=policy)
    return x + y2.reshape(B, C, E), cache


def _attn_decode(p, x, pos, cache, *, kind, cfg, policy, paged,
                 block_tables, norm=None, residual=None):
    """The layer's decode attention: the block pools when `paged`, else a
    dense per-slot cache, whose shape picks the branch as in the
    reference: a ring of exactly `window` slots (a window layer of the
    paged layout), or a linear cache of the layout's max_seq rows — any
    row count for a full-context kind (the dense layout of a speculative
    draft), fewer rows than the window for a window kind (a window that
    spans the whole sequence).  A window kind's dense cache longer than
    its window is neither, and raises."""
    if paged:
        return attn.attn_decode_paged(p, x, pos, cache, block_tables,
                                      cfg=cfg, policy=policy, norm=norm,
                                      residual=residual)
    window = kind_window(kind, cfg)
    if window > 0 and cache["k"].shape[1] > window:
        raise ValueError(f"{kind}: a dense decode cache is a ring of "
                         f"{window} slots or a linear cache of fewer rows, "
                         f"not {cache['k'].shape[1]}")
    return attn.attn_decode(p, x, pos, cache, cfg=cfg, policy=policy,
                            window=window, norm=norm, residual=residual)


def block_decode(kind: str, p, x, pos, cache, *, cfg, policy,
                 block_tables, fused: bool = True, paged: bool = True,
                 memory_len: int = 0):
    """x: [B, E]; pos: [B]; cache: this layer's cache views — {"k", "v"}
    block pools (`paged`) or dense per-slot [B, W, KV, hd] ring caches, and
    / or the SSM state {"h", "cx", "cbc"} — updated in place; a ``dec``
    layer's also its cross cache {"ck", "cv"} [B, Sm, KV, hd], read only,
    of which every row attends the first `memory_len` rows.
    -> (x', cache).  A bidirectional (encoder) kind has no decode step and
    raises."""
    _require_ported(kind)
    if kind in BIDIR_KINDS:
        raise ValueError(f"block kind {kind!r} is bidirectional: an encoder "
                         f"has no decode step")
    if kind == "ssm":
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, sc = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg=cfg,
                                   policy=policy)
        _store_state(cache, sc)
        return x + y, cache
    hybrid = kind in HYBRID_KINDS
    kv_kw = dict(kind=kind, cfg=cfg, policy=policy, paged=paged,
                 block_tables=block_tables)
    if kind in MOE_KINDS:
        if fused:
            y, _ = _attn_decode(p["attn"], x, pos, cache,
                                norm=ops.norm_prologue(p["ln1"], cfg.norm),
                                **kv_kw)
        else:
            y, _ = _attn_decode(p["attn"], ops.norm(x, p["ln1"], cfg.norm),
                                pos, cache, **kv_kw)
        h2, x = _moe_boundary(x, y, p, cfg=cfg, fused=fused)
        return x + mlp_mod.moe_decode(p["moe"], h2, cfg=cfg, policy=policy,
                                      fused=fused), cache
    if fused and not hybrid:
        x, _ = _attn_decode(p["attn"], x, pos, cache,
                            norm=ops.norm_prologue(p["ln1"], cfg.norm),
                            residual=x, **kv_kw)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, _ = _attn_decode(p["attn"], h, pos, cache, **kv_kw)
    if kind == "dec":
        xkw = dict(cfg=cfg, policy=policy, window=0, cross=True,
                   memory_len=memory_len)
        mem = {"k": cache["ck"], "v": cache["cv"]}
        if fused:
            x, _ = attn.attn_decode(p["xattn"], x, pos, mem,
                                    norm=ops.norm_prologue(p["lnx"],
                                                           cfg.norm),
                                    residual=x, **xkw)
        else:
            x = x + y
            yx, _ = attn.attn_decode(p["xattn"],
                                     ops.norm(x, p["lnx"], cfg.norm), pos,
                                     mem, **xkw)
            x, y = x + yx, None
    if hybrid:
        s, sc = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg=cfg,
                                   policy=policy)
        y = (y + s) * 0.5
        _store_state(cache, sc)
    if fused and hybrid:
        h2, x = ops.residual_norm(x, y, p["ln2"], cfg.norm)
        x = mlp_mod.mlp_decode(p["mlp"], h2, cfg=cfg, policy=policy,
                               residual=x)
    elif fused:
        x = mlp_mod.mlp_decode(p["mlp"], x, cfg=cfg, policy=policy,
                               norm=ops.norm_prologue(p["ln2"], cfg.norm),
                               residual=x)
    else:
        if y is not None:
            x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_decode(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, cache

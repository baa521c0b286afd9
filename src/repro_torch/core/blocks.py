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
  ``vit``           the ``attn`` block with bidirectional attention (the
                    paper's encoder-only topology): full-sequence passes
                    only, no decode step

Full-context attention layers keep their KV in the block pool
(`kind_paged`); a window shorter than max_seq keeps a dense per-slot ring
cache of `window` slots instead.  The other kinds of the reference (MoE,
encoder / decoder) raise NotImplementedError."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN_KINDS, LOCAL_KINDS, SSM_KINDS
from repro_torch.core import attention as attn
from repro_torch.core import mlp as mlp_mod
from repro_torch.core import ssm as ssm_mod
from repro_torch.kernels import ops

PORTED_KINDS = ("attn", "local", "ssm", "hybrid_attn", "hybrid_local",
                "vit")
HYBRID_KINDS = ("hybrid_attn", "hybrid_local")
BIDIR_KINDS = ("enc", "vit")
SSM_STATE = ("h", "cx", "cbc")


def _require_ported(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


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
    if kind != "ssm":
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
    layer from `generator`: N(0, 0.02) attention / MLP weights, unit norms,
    SSM leaves as `ssm.init_ssm` draws them."""
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
    if kind != "ssm":
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


def block_full(kind: str, p, x, *, cfg, policy, fused: bool = True,
               with_cache: bool = False, max_seq: int = 0,
               compact_kv: bool = False):
    """x: [B, S, E] -> (x', cache | None).  A paged layer's KV cache has
    `max_seq` rows, or with `compact_kv` the sequence's own length (paged
    admission scatters it into pool blocks); a ring layer's is always its
    `window` slots, so that admission overwrites the whole slot row."""
    _require_ported(kind)
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
    if fused and not hybrid:
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
    if fused and hybrid:
        h2, x = ops.residual_norm(x, y, p["ln2"], cfg.norm)
        x = mlp_mod.mlp_full(p["mlp"], h2, cfg=cfg, policy=policy,
                             residual=x)
    elif fused:
        x = mlp_mod.mlp_full(p["mlp"], x, cfg=cfg, policy=policy,
                             norm=ops.norm_prologue(p["ln2"], cfg.norm),
                             residual=x)
    else:
        x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_full(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, cache


def _attn_decode(p, x, pos, cache, *, kind, cfg, policy, paged,
                 block_tables, norm=None, residual=None):
    """The layer's decode attention: the block pools when `paged`, else the
    dense per-slot ring cache of `window` slots (`kind_paged`)."""
    if paged:
        return attn.attn_decode_paged(p, x, pos, cache, block_tables,
                                      cfg=cfg, policy=policy, norm=norm,
                                      residual=residual)
    window = kind_window(kind, cfg)
    if cache["k"].shape[1] != window:
        raise ValueError(f"{kind}: a dense decode cache is a ring of "
                         f"{window} slots, not {cache['k'].shape[1]}")
    return attn.attn_decode(p, x, pos, cache, cfg=cfg, policy=policy,
                            window=window, norm=norm, residual=residual)


def block_decode(kind: str, p, x, pos, cache, *, cfg, policy,
                 block_tables, fused: bool = True, paged: bool = True):
    """x: [B, E]; pos: [B]; cache: this layer's cache views — {"k", "v"}
    block pools (`paged`) or dense per-slot [B, W, KV, hd] ring caches, and
    / or the SSM state {"h", "cx", "cbc"} — updated in place.
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
    if fused and not hybrid:
        x, _ = _attn_decode(p["attn"], x, pos, cache,
                            norm=ops.norm_prologue(p["ln1"], cfg.norm),
                            residual=x, **kv_kw)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, _ = _attn_decode(p["attn"], h, pos, cache, **kv_kw)
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
        x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_decode(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, cache

"""Blocks of the kinds the port serves (port of the reference's
core/blocks.py, single device), fused (norm prologues and residual
epilogues inside the GEMMs, add + norm in one pass where no GEMM can absorb
it) or unfused (the discrete norm -> GEMM -> add chain):

  ``attn``          pre-norm attention + dense MLP
  ``ssm``           pre-norm Mamba2 SSD block (attention-free, no MLP)
  ``hybrid_attn``   attention and SSM heads in parallel on one normalized
                    input, outputs averaged, then a dense MLP
  ``hybrid_local``  the same with sliding-window attention

The other kinds of the reference (MoE, encoder / decoder, ViT) raise
NotImplementedError, and so does any attention layer whose window is
shorter than max_seq: that needs the reference's ring cache, which is not
ported (`kind_paged`)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN_KINDS, LOCAL_KINDS, SSM_KINDS
from repro_torch.core import attention as attn
from repro_torch.core import mlp as mlp_mod
from repro_torch.core import ssm as ssm_mod
from repro_torch.kernels import ops

PORTED_KINDS = ("attn", "ssm", "hybrid_attn", "hybrid_local")
HYBRID_KINDS = ("hybrid_attn", "hybrid_local")
BIDIR_KINDS = ("enc", "vit")
SSM_STATE = ("h", "cx", "cbc")


def _require_ported(kind: str):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _norm_shapes(cfg):
    E = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": (E,)}
    return {"scale": (E,), "bias": (E,)}


def _init_norm(cfg, dtype, device, count=None):
    lead = () if count is None else (count,)
    p = {"scale": torch.ones(lead + (cfg.d_model,), dtype=dtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                device=device)
    return p


def block_param_shapes(kind: str, cfg) -> dict:
    _require_ported(kind)
    out = {"ln1": _norm_shapes(cfg)}
    if kind in ATTN_KINDS:
        out["attn"] = attn.attention_param_shapes(cfg)
    if kind in SSM_KINDS:
        out["ssm"] = ssm_mod.ssm_param_shapes(cfg)
    if kind != "ssm":
        out["ln2"] = _norm_shapes(cfg)
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
    out = {"ln1": _init_norm(cfg, dtype, device, count)}
    if kind in ATTN_KINDS:
        out["attn"] = _init_normal(generator, attn.attention_param_shapes(cfg),
                                   dtype, device, count)
    if kind in SSM_KINDS:
        layers = [ssm_mod.init_ssm(generator, cfg, dtype, device)
                  for _ in range(count)]
        out["ssm"] = {k: torch.stack([lp[k] for lp in layers])
                      for k in layers[0]}
    if kind != "ssm":
        out["ln2"] = _init_norm(cfg, dtype, device, count)
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
    window shorter than max_seq needs a dense ring cache (not ported)."""
    return kind in ATTN_KINDS and kind_cache_len(kind, cfg, max_seq) == max_seq


def ring_cache_error(kind: str, cfg) -> NotImplementedError:
    return NotImplementedError(
        f"kind {kind!r} with sliding window {cfg.sliding_window} shorter "
        f"than max_seq needs a ring cache; ring caches (and the dense "
        f"decode_attention kernel they feed) are not ported yet")


def require_paged(kind: str, cfg, max_seq: int):
    """Refuse a layer that would need a ring cache: the port never falls
    back to a full cache for a window layer."""
    if kind in ATTN_KINDS and not kind_paged(kind, cfg, max_seq):
        raise ring_cache_error(kind, cfg)


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
    """x: [B, S, E] -> (x', cache | None).  `compact_kv`: the KV cache at the
    sequence's own length instead of `max_seq` (paged admission scatters it
    into pool blocks)."""
    _require_ported(kind)
    if kind == "ssm":
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, sc = ssm_mod.ssm_full(p["ssm"], h, cfg=cfg, policy=policy,
                                 with_cache=with_cache)
        return x + y, sc
    cache_len = 0
    if with_cache:
        require_paged(kind, cfg, max_seq)
        cache_len = x.shape[1] if compact_kv else max_seq
    causal = kind_causal(kind, cfg)
    window = kind_window(kind, cfg)
    hybrid = kind in HYBRID_KINDS
    if fused and not hybrid:
        x, kv = attn.attn_full(p["attn"], x, cfg=cfg, policy=policy,
                               causal=causal, window=window,
                               with_cache=with_cache, cache_len=cache_len,
                               norm=ops.norm_prologue(p["ln1"], cfg.norm),
                               residual=x)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, kv = attn.attn_full(p["attn"], h, cfg=cfg, policy=policy,
                               causal=causal, window=window,
                               with_cache=with_cache, cache_len=cache_len)
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


def block_decode(kind: str, p, x, pos, cache, *, cfg, policy,
                 block_tables, fused: bool = True, kv_splits: int = 1):
    """x: [B, E]; pos: [B]; cache: this layer's cache views — {"k", "v"}
    pools and / or the SSM state {"h", "cx", "cbc"} — updated in place.
    -> (x', cache)."""
    _require_ported(kind)
    if kind == "ssm":
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, sc = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg=cfg,
                                   policy=policy)
        _store_state(cache, sc)
        return x + y, cache
    hybrid = kind in HYBRID_KINDS
    if fused and not hybrid:
        x, _ = attn.attn_decode_paged(
            p["attn"], x, pos, cache, block_tables, cfg=cfg, policy=policy,
            norm=ops.norm_prologue(p["ln1"], cfg.norm), residual=x,
            kv_splits=kv_splits)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, _ = attn.attn_decode_paged(p["attn"], h, pos, cache,
                                      block_tables, cfg=cfg, policy=policy,
                                      kv_splits=kv_splits)
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

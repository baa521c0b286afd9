"""Transformer blocks of kind `attn` (port of the reference's core/blocks.py
for the decoder path): pre-norm residual attention + dense MLP, fused
(norm prologues and residual epilogues inside the GEMMs) or unfused (the
discrete norm -> GEMM -> add chain)."""
from __future__ import annotations

import torch

from repro_torch.core import attention as attn
from repro_torch.core import mlp as mlp_mod
from repro_torch.kernels import ops

ATTN_KINDS = ("attn",)
BIDIR_KINDS = ("enc", "vit")


def _require_attn(kind: str):
    if kind not in ATTN_KINDS:
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
    _require_attn(kind)
    return {"ln1": _norm_shapes(cfg), "attn": attn.attention_param_shapes(cfg),
            "ln2": _norm_shapes(cfg), "mlp": mlp_mod.mlp_param_shapes(cfg)}


def init_block(generator, kind: str, cfg, dtype, device, count: int):
    """`count` stacked layers of `kind` (leading layer dim), weights
    N(0, 0.02) drawn layer by layer from `generator`."""
    _require_attn(kind)
    out = {"ln1": _init_norm(cfg, dtype, device, count),
           "ln2": _init_norm(cfg, dtype, device, count)}
    for group, shapes in (("attn", attn.attention_param_shapes(cfg)),
                          ("mlp", mlp_mod.mlp_param_shapes(cfg))):
        out[group] = {}
        for name, shape in shapes.items():
            w = torch.empty((count,) + shape, dtype=dtype, device=device)
            for i in range(count):
                w[i] = torch.randn(shape, generator=generator,
                                   device=device) * 0.02
            out[group][name] = w
    return out


def kind_causal(kind: str, cfg) -> bool:
    if kind in BIDIR_KINDS:
        return False
    return cfg.causal


def kind_cache_len(kind: str, cfg, max_seq: int) -> int:
    """KV-cache slots for this kind (no sliding-window kind is ported)."""
    return max_seq


def kind_paged(kind: str, cfg, max_seq: int) -> bool:
    """Full-context attention layers keep their KV in the block pool."""
    return kind in ATTN_KINDS and kind_cache_len(kind, cfg, max_seq) == max_seq


def block_full(kind: str, p, x, *, cfg, policy, fused: bool = True,
               with_cache: bool = False, max_seq: int = 0,
               compact_kv: bool = False):
    """x: [B, S, E] -> (x', cache | None).  `compact_kv`: the KV cache at the
    sequence's own length instead of `max_seq` (paged admission scatters it
    into pool blocks)."""
    _require_attn(kind)
    causal = kind_causal(kind, cfg)
    cache_len = kind_cache_len(kind, cfg, max_seq) if with_cache else 0
    if compact_kv and kind_paged(kind, cfg, max_seq):
        cache_len = x.shape[1]
    if fused:
        x, kv = attn.attn_full(p["attn"], x, cfg=cfg, policy=policy,
                               causal=causal, with_cache=with_cache,
                               cache_len=cache_len,
                               norm=ops.norm_prologue(p["ln1"], cfg.norm),
                               residual=x)
        x = mlp_mod.mlp_full(p["mlp"], x, cfg=cfg, policy=policy,
                             norm=ops.norm_prologue(p["ln2"], cfg.norm),
                             residual=x)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, kv = attn.attn_full(p["attn"], h, cfg=cfg, policy=policy,
                               causal=causal, with_cache=with_cache,
                               cache_len=cache_len)
        x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_full(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, kv


def block_decode(kind: str, p, x, pos, cache, *, cfg, policy,
                 block_tables, fused: bool = True, kv_splits: int = 1):
    """x: [B, E]; pos: [B]; cache: this layer's {"k", "v"} pools (updated in
    place).  -> (x', cache)."""
    _require_attn(kind)
    if fused:
        x, cache = attn.attn_decode_paged(
            p["attn"], x, pos, cache, block_tables, cfg=cfg, policy=policy,
            norm=ops.norm_prologue(p["ln1"], cfg.norm), residual=x,
            kv_splits=kv_splits)
        x = mlp_mod.mlp_decode(p["mlp"], x, cfg=cfg, policy=policy,
                               norm=ops.norm_prologue(p["ln2"], cfg.norm),
                               residual=x)
    else:
        h = ops.norm(x, p["ln1"], cfg.norm)
        y, cache = attn.attn_decode_paged(p["attn"], h, pos, cache,
                                          block_tables, cfg=cfg,
                                          policy=policy, kv_splits=kv_splits)
        x = x + y
        h2 = ops.norm(x, p["ln2"], cfg.norm)
        x = x + mlp_mod.mlp_decode(p["mlp"], h2, cfg=cfg, policy=policy)
    return x, cache

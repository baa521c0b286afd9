"""Decoder-only language model over the segment schedule (port of the
reference's models/lm.py serving path).

Parameters keep the reference's tree: `embedding/{embed, unemb}`,
`final_norm/{scale, bias}`, and one dict per schedule segment whose leaves
carry the layer dim first (`segments[i]/{ln1, ln2, attn/{wq, wk, wv, wo},
mlp/{w1 | wg, wu, w2}, ssm/{w_x, w_z, w_bc, w_dt, dt_bias, a_log, d_skip,
conv_x, conv_bc, norm_scale, w_out}}`, each group where the kind has it).
The reference scans each segment with `lax.scan`; the port runs a Python
loop over its layers (`launch/steps.py` captures the decode step's launches
in one CUDA graph).

Modes: `forward_prefill` (NAR prompt pass, optional right-padding to a
length bucket — exact only without SSM state or ring caches — and compact
KV for paged admission), `forward_encode` (the same stack with no cache,
pooled to one fp32 vector a row) and `forward_decode` (one AR step against
the paged pools, the per-slot ring caches of window layers and the
per-slot SSM state, which it updates in place).
"""
from __future__ import annotations

import torch

from repro_torch.core import blocks
from repro_torch.core.embedding import (embed_sequence, embed_token,
                                        embedding_param_shapes, greedy_token,
                                        init_embedding, sample_token)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.params import layer, tree_from_numpy


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def lm_param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (segment leaves with the layer dim
    leading)."""
    def stack(tree, count):
        return {k: (stack(v, count) if isinstance(v, dict)
                    else (count,) + tuple(v)) for k, v in tree.items()}
    return {
        "embedding": embedding_param_shapes(cfg),
        "final_norm": blocks.norm_shapes(cfg),
        "segments": tuple(stack(blocks.block_param_shapes(kind, cfg), count)
                          for kind, count in cfg.schedule),
    }


def init_lm(cfg, *, dtype=torch.bfloat16, device=None, seed: int = 0):
    """Random N(0, 0.02) weights (unit / zero norms) from a seeded
    `torch.Generator`, made on the device (the GPU unless device="cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    segs = tuple(blocks.init_block(gen, kind, cfg, dtype, dev, count)
                 for kind, count in cfg.schedule)
    return {"embedding": init_embedding(gen, cfg, dtype, dev),
            "final_norm": blocks.init_norm(cfg, dtype, dev),
            "segments": segs}


def params_from_numpy(tree, cfg, *, dtype=torch.float32, device=None):
    """The reference's parameter tree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, lm.init_lm(...))`) -> the port's parameters.
    bf16 leaves pass through float32, which is exact; the {"q", "scale"}
    leaves of a quantized tree (`quantize_params`) keep int8 q and fp32
    scales.  Raises on a missing leaf or a shape that does not match
    `cfg`."""
    return tree_from_numpy(tree, lm_param_shapes(cfg), dtype=dtype,
                           device=device)


# --------------------------------------------------------------------------
# segment runners
# --------------------------------------------------------------------------

def _embed_sequence(params, tokens, *, policy):
    return embed_sequence(params["embedding"]["embed"], tokens,
                          policy=policy)


def _run_segments_prefill(params, x, *, cfg, policy, max_seq, fused=True,
                          compact_kv=False, with_cache=True):
    """-> (x [B, S, E], caches): one dict per segment of stacked leaves —
    k / v [count, B, S_cache, KV, hd] at the activation dtype for attention
    kinds (ring layers: S_cache = window, in slot order), the SSM state
    h [count, B, Hp, P, N] and conv tails cx / cbc [count, B, cw - 1, .]
    for SSM kinds.  `with_cache=False` runs the same stack and builds no
    cache (the encode pass); caches is then None."""
    caches = []
    for (kind, count), p_seg in zip(cfg.schedule, params["segments"]):
        layers = []
        for i in range(count):
            x, cache = blocks.block_full(kind, layer(p_seg, i), x, cfg=cfg,
                                         policy=policy, fused=fused,
                                         with_cache=with_cache,
                                         max_seq=max_seq,
                                         compact_kv=compact_kv)
            layers.append(cache)
        if with_cache:
            caches.append({k: torch.stack([c[k] for c in layers])
                           for k in layers[0]})
    return x, (tuple(caches) if with_cache else None)


def _run_segments_decode(params, x, pos, caches, *, cfg, policy,
                         block_tables, fused=True, paged_segments=None):
    """Every layer's decode step; pool, ring-cache and SSM-state leaves are
    updated in place.  `paged_segments`: per segment, whether its k / v are
    block pools (the layout's `segments`); None: every segment's are."""
    paged_segments = paged_segments or (True,) * len(cfg.schedule)
    for (kind, count), p_seg, c_seg, paged in zip(
            cfg.schedule, params["segments"], caches, paged_segments):
        for i in range(count):
            x, _ = blocks.block_decode(kind, layer(p_seg, i), x, pos,
                                       layer(c_seg, i), cfg=cfg,
                                       policy=policy,
                                       block_tables=block_tables,
                                       fused=fused, paged=paged)
    return x, caches


def _head_norm(params, cfg, fused: bool):
    """Final-norm prologue for the fused logits head (None: the unfused
    chain applies ops.norm first)."""
    if not fused:
        return None
    return ops.norm_prologue(params["final_norm"], cfg.norm)


def _residual_at(x, idx):
    """x: [B, S, E]; idx: [B] positions -> [B, E]."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, idx.long()]


def _lengths(tokens, prompt_len):
    """[B] int64 true lengths on the tokens' device: `prompt_len` (host
    array or tensor), or every row's full length S."""
    B, S = tokens.shape
    if prompt_len is None:
        return torch.full((B,), S, dtype=torch.int64, device=tokens.device)
    return torch.as_tensor(prompt_len, device=tokens.device).to(torch.int64)


def _choose(x, params, lane, step, *, cfg, policy, norm):
    unemb = params["embedding"]["unemb"]
    if lane is None:
        return greedy_token(x, unemb, cfg=cfg, policy=policy, norm=norm)
    return sample_token(x, unemb, dict(lane, step=step), cfg=cfg,
                        policy=policy, norm=norm)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def forward_prefill(params, tokens, *, cfg, policy, max_seq: int,
                    prompt_len=None, lane=None, compact_kv: bool = False,
                    fused: bool = True):
    """NAR prompt pass.  tokens: [B, S] -> (next_token [B], caches, pos [B]).

    `prompt_len` ([B] ints, a host array or a tensor on the tokens' device,
    optional): true lengths of rows right-padded to a length bucket; the
    next token is read at each row's last true position.  `lane` (per-row
    sampling tensors on the tokens' device, see
    core.embedding._lane_scores, without "step": the sampled token's
    position is each row's length): greedy when None."""
    x = _embed_sequence(params, tokens, policy=policy)
    x, caches = _run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                      max_seq=max_seq, fused=fused,
                                      compact_kv=compact_kv)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    pos = _lengths(tokens, prompt_len)
    x_last = _residual_at(x, pos - 1)
    tok = _choose(x_last, params, lane, pos, cfg=cfg, policy=policy,
                  norm=head_norm)
    return tok, caches, pos.to(torch.int32)


def forward_encode(params, tokens, *, cfg, policy, prompt_len=None,
                   pooling: str = "last", fused: bool = True):
    """Encoder-only NAR pass: one full-sequence forward, no KV cache, no
    sampling.  tokens: [B, S] -> pooled [B, E] float32.

    `prompt_len` ([B] ints, host or device, optional): true lengths of
    rows right-padded to a length bucket.  Padding is output-exact only for
    causal schedules (a bidirectional kind attends its pads); the runner
    pads only when every kind is causal.
    `pooling`: "last" — the normalized residual at the last true position
    (what a prefill samples from); "mean" — the masked fp32 mean of the
    normalized rows over the true positions.  Fused "last" selects the raw
    row and normalizes only that row (the norm is row-wise); mean pooling
    normalizes every row first (the norm of a mean is not the mean of the
    norms)."""
    if cfg.n_patches or cfg.enc_schedule:
        raise NotImplementedError(f"{cfg.name}: encode passes with a patch "
                                  f"prefix or an encoder schedule are not "
                                  f"ported")
    if pooling not in ("last", "mean"):
        raise ValueError(f"pooling must be 'last' or 'mean': {pooling!r}")
    x = _embed_sequence(params, tokens, policy=policy)
    x, _ = _run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                 max_seq=0, fused=fused, with_cache=False)
    fused_head = fused and pooling == "last"
    if not fused_head:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    S = tokens.shape[1]
    pos = _lengths(tokens, prompt_len)
    if pooling == "last":
        row = _residual_at(x, pos - 1)
        if fused_head:
            row = ops.norm(row, params["final_norm"], cfg.norm)
        return row.float()
    keep = (torch.arange(S, device=x.device)[None, :] < pos[:, None])
    s = (x.float() * keep[..., None]).sum(1)
    return s / pos.clamp(min=1).float()[:, None]


def forward_decode(params, token, pos, caches, *, cfg, policy,
                   block_tables, lane=None, fused: bool = True,
                   paged_segments=None):
    """One AR step.  token, pos: [B] device tensors; block_tables [B, MB]
    -> (next_token [B], caches).  `lane` (per-row sampling tensors on the
    device, without "step": a sampled token's step is pos + 1, the position
    it will occupy, as the reference's): greedy when None.
    `paged_segments`: per segment, pools or ring caches (the layout's
    `segments`; None: pools everywhere).  No host value reaches the device
    and every launch depends on the shapes alone: `launch/steps.py`
    captures this function in a CUDA graph."""
    x = embed_token(params["embedding"]["embed"], token, policy=policy)
    x, caches = _run_segments_decode(params, x, pos, caches, cfg=cfg,
                                     policy=policy, block_tables=block_tables,
                                     fused=fused,
                                     paged_segments=paged_segments)
    head_norm = _head_norm(params, cfg, fused)
    if head_norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    tok = _choose(x, params, lane, pos + 1, cfg=cfg, policy=policy,
                  norm=head_norm)
    return tok, caches

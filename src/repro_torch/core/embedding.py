"""Embedding, logits head and token choice on one device (port of the
reference's core/embedding.py).

The logits head is the step's largest GEMM: [B, E] @ [E, padded_vocab] in
fp32 with the final LayerNorm fused as its prologue; padded vocabulary
columns are masked to -1e30.  Sampling is Gumbel-max — argmax(z / T + g) —
with the reference's top-k threshold rule.  The noise is the reference's
own draw — threefry keyed by fold_in(fold_in(key(seed), step), shard 0)
over the padded vocabulary (`core/prng.py`), bit-equal uniforms — so one
(seed, position) pair samples the same token in both packages, whatever
the batch slot.  `_lane_scores(noise=)` takes the noise from the caller
instead.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.nn import act_dtype, fused_pdot

NEG_INF = -1e30
TOP_K_CAP = 64


def embedding_param_shapes(cfg) -> dict:
    Vp, E = cfg.padded_vocab, cfg.d_model
    return {"embed": (Vp, E), "unemb": (E, Vp)}


def init_embedding(generator, cfg, dtype, device):
    shapes = embedding_param_shapes(cfg)
    return {n: (torch.randn(s, generator=generator, device=device) * 0.02
                ).to(dtype) for n, s in shapes.items()}


def embed_sequence(emb, ids, *, policy):
    """ids: [B, S] -> [B, S, E] at the activation dtype."""
    return emb[ids.long()].to(act_dtype(policy))


def embed_token(emb, ids, *, policy):
    """ids: [B] -> [B, E] at the activation dtype."""
    return emb[ids.long()].to(torch.float32).to(act_dtype(policy))


def logits_local(x, unemb, *, cfg, policy, norm=None):
    """x: [B, E] -> z [B, Vp] fp32 with padded columns masked.  `norm`: the
    final norm fused into the logits GEMM as its prologue."""
    z = fused_pdot(x, unemb, policy, prologue=norm, out_dtype=torch.float32)
    real = torch.arange(z.shape[-1], device=z.device)[None, :] < cfg.vocab
    return z.masked_fill(~real, NEG_INF)


def greedy_token(x, unemb, *, cfg, policy, norm=None):
    """x: [B, E] -> [B] int32 argmax (ties to the lowest id)."""
    z = logits_local(x, unemb, cfg=cfg, policy=policy, norm=norm)
    return torch.argmax(z, dim=-1).to(torch.int32)


def sample_token(x, unemb, lane, *, cfg, policy, norm=None):
    """x: [B, E] -> [B] int32 sampled per row (greedy rows: argmax).  `lane`
    as in `_lane_scores`."""
    z = logits_local(x, unemb, cfg=cfg, policy=policy, norm=norm)
    return torch.argmax(_lane_scores(z, lane), dim=-1).to(torch.int32)


def gumbel_noise(lane, n_cols: int) -> torch.Tensor:
    """[B, n_cols] fp32 Gumbel(0, 1) noise on the lane's device: row b
    draws from fold_in(fold_in(key(seed[b]), step[b]), 0); greedy rows
    (temperature <= 0) get zeros.  Every row is drawn, whatever its
    temperature, so the work does not depend on the lane's values."""
    k = prng.fold_in(prng.fold_in(prng.key(lane["seed"]), lane["step"]), 0)
    g = prng.gumbel(k, n_cols)
    return g.masked_fill((lane["temperature"] <= 0)[:, None], 0.0)


def _lane_scores(z, lane, *, noise=None):
    """Per-row scores whose argmax IS the chosen token: greedy rows
    (temperature <= 0) keep the raw logits, sampled rows get top-k-masked,
    temperature-scaled, Gumbel-perturbed logits.

    z: [B, V] fp32.  lane: per-row tensors on z's device (`serving.sampling.
    device_lane`) "temperature" fp32, "top_k" int, "seed" int, "step" int
    ([B] each).  `noise` [B, V] replaces the drawn Gumbel noise.  No host
    value reaches the device: the step that samples can be captured."""
    V = z.shape[1]
    t = lane["temperature"].float()
    k = lane["top_k"].long()
    sampled = t > 0.0
    kcap = min(TOP_K_CAP, V)
    top = torch.topk(z, kcap, dim=-1).values                    # [B, kcap]
    kth = torch.clamp(k, 1, kcap) - 1
    thresh = top.gather(1, kth[:, None])
    keep = (k[:, None] <= 0) | (z >= thresh)
    g = noise if noise is not None else gumbel_noise(lane, V)
    t_safe = torch.where(sampled, torch.clamp(t, min=1e-6),
                         torch.ones_like(t))
    masked = z.masked_fill(~keep, NEG_INF)
    return torch.where(sampled[:, None], masked / t_safe[:, None] + g, z)

"""Draft-model configs for speculative decoding (copy of the reference's
configs/drafts.py; `serving/spec.py`).

A draft is a *small* causal LM that shares the target's tokenizer — the
same `vocab`, so the same padded vocabulary — so its proposed token ids
compare directly with the target's.  The draft never needs to be *good*:
acceptance is verified against the target exactly, so a weak draft costs
acceptance rate, never correctness.

`make_draft(cfg)` derives a 2-layer GPT-J-shaped draft from any decoder
config: plain global-attention layers (no MoE / SSM / sliding window /
encoder: those change the cache layout, and the draft keeps a dense linear
cache a slot), the target's widths, and a reduced target derives a reduced
draft.  Named drafts (`<target>-draft`) are registered in
`repro_torch.configs.REGISTRY` for the reference's targets: GPT-J,
GPT3-XL, phi4-mini, chatglm3-6b, deepseek-67b and mixtral-8x7b (a dense
SwiGLU `attn` draft: `make_draft` strips the experts).  internvl2-76b has
none, as in the reference: a VLM cannot speculate, and `make_draft` strips
its patch prefix.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

DRAFT_LAYERS = 2


def make_draft(cfg: ModelConfig, n_layers: int = DRAFT_LAYERS) -> ModelConfig:
    """A tiny draft LM sharing `cfg`'s vocabulary: `n_layers` plain
    causal-attention layers, everything cache-layout-exotic stripped."""
    if not cfg.vocab:
        raise ValueError(
            f"{cfg.name} has no token vocabulary — a draft LM needs the "
            f"target's tokenizer (decoder LMs only)")
    n = max(1, min(n_layers, cfg.n_layers))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-draft",
        family="dense",
        n_layers=n,
        schedule=(("attn", n),),
        sliding_window=0,
        n_experts=0,
        top_k=0,
        ssm_state=0,
        d_inner=0,
        n_enc_layers=0,
        enc_schedule=(),
        enc_seq=0,
        n_patches=0,
        n_classes=0,
        image_seq=0,
    )


def _paper_drafts() -> dict:
    from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3
    from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK67B
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
    from repro_torch.configs.paper_models import GPT3_XL, GPT_J
    from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI
    targets = (GPT_J, GPT3_XL, PHI4_MINI, CHATGLM3, DEEPSEEK67B,
               MIXTRAL_8X7B)
    return {d.name: d for d in (make_draft(t) for t in targets)}


DRAFTS = _paper_drafts()

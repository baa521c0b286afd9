"""Configurations the port runs: the paper's encoder-only ViT-B/L/H
(`models.vit`) and decoder-only models,
phi4-mini (SwiGLU, RMSNorm, GQA), hymba-1.5b (parallel attention + Mamba2
heads), mamba2-2.7b (attention-free SSD) and gemma3-27b (5:1 sliding-window
/ global attention, GELU MLP)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.paper_models import (GPT3_XL, GPT_J, PAPER_MODELS,
                                             VIT_B, VIT_H, VIT_L)
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI

REGISTRY = dict(PAPER_MODELS)
for _cfg in (PHI4_MINI, HYMBA_1_5B, MAMBA2_2_7B, GEMMA3_27B):
    REGISTRY[_cfg.name] = _cfg


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "VIT_B", "VIT_L", "VIT_H", "GPT_J", "GPT3_XL",
           "PHI4_MINI", "HYMBA_1_5B", "MAMBA2_2_7B", "GEMMA3_27B",
           "PAPER_MODELS", "get_config"]

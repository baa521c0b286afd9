"""Configurations the port serves: the paper's decoder-only models and
phi4-mini (SwiGLU, RMSNorm, GQA)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import GPT3_XL, GPT_J, PAPER_MODELS
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI

REGISTRY = dict(PAPER_MODELS)
REGISTRY[PHI4_MINI.name] = PHI4_MINI


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "GPT_J", "GPT3_XL", "PHI4_MINI", "PAPER_MODELS",
           "get_config"]

"""Configurations the port serves: the paper's decoder-only models."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import GPT3_XL, GPT_J, PAPER_MODELS


def get_config(name: str) -> ModelConfig:
    if name not in PAPER_MODELS:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(PAPER_MODELS)}")
    return PAPER_MODELS[name]


__all__ = ["ModelConfig", "GPT_J", "GPT3_XL", "PAPER_MODELS", "get_config"]

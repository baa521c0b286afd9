"""Configurations the port runs: the paper's encoder-only ViT-B/L/H
(`models.vit`) and decoder-only models,
phi4-mini (SwiGLU, RMSNorm, GQA), chatglm3-6b (GQA 32 / 2, rope on half
of each head), deepseek-67b, internvl2-76b (a VLM backbone behind a
256-position patch prefix), hymba-1.5b (parallel attention + Mamba2
heads), mamba2-2.7b (attention-free SSD), gemma3-27b (5:1 sliding-window
/ global attention, GELU MLP), mixtral-8x7b and mixtral-8x22b (8 SwiGLU
experts, top-2, a 4096 window), whisper-base (an encoder-decoder: 6
bidirectional encoder layers over 1504 stub frames, 6 decoder layers with
cross-attention, sinusoidal positions), and the 2-layer
speculative-decoding drafts of the decoder targets (`configs/drafts.py`:
`<target>-draft`).  `get_config` also takes the reference's CLI aliases
(`ALIASES`: e.g. `whisper_base`)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3_6B
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.drafts import DRAFTS, make_draft
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3_27B
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA_1_5B
from repro_torch.configs.internvl2_76b import CONFIG as INTERNVL2_76B
from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA2_2_7B
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from repro_torch.configs.paper_models import (GPT3_XL, GPT_J, PAPER_MODELS,
                                             VIT_B, VIT_H, VIT_L)
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI
from repro_torch.configs.whisper_base import CONFIG as WHISPER_BASE

REGISTRY = dict(PAPER_MODELS)
for _cfg in (PHI4_MINI, CHATGLM3_6B, DEEPSEEK_67B, INTERNVL2_76B,
             HYMBA_1_5B, MAMBA2_2_7B, GEMMA3_27B, MIXTRAL_8X7B,
             MIXTRAL_8X22B, WHISPER_BASE):
    REGISTRY[_cfg.name] = _cfg
REGISTRY.update(DRAFTS)

# the reference's CLI-friendly aliases (--arch <id>): each assigned config
# by its name and with underscores
ALIASES = {}
for _cfg in (PHI4_MINI, CHATGLM3_6B, DEEPSEEK_67B, GEMMA3_27B,
             MIXTRAL_8X22B, MIXTRAL_8X7B, INTERNVL2_76B, HYMBA_1_5B,
             MAMBA2_2_7B, WHISPER_BASE):
    ALIASES[_cfg.name] = _cfg.name
    ALIASES[_cfg.name.replace("-", "_").replace(".", "_")] = _cfg.name


def get_config(name: str) -> ModelConfig:
    name = ALIASES.get(name, name)
    if name not in REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port serves "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "VIT_B", "VIT_L", "VIT_H", "GPT_J", "GPT3_XL",
           "PHI4_MINI", "CHATGLM3_6B", "DEEPSEEK_67B", "INTERNVL2_76B",
           "HYMBA_1_5B", "MAMBA2_2_7B", "GEMMA3_27B",
           "MIXTRAL_8X7B", "MIXTRAL_8X22B", "WHISPER_BASE",
           "PAPER_MODELS", "DRAFTS", "ALIASES", "make_draft", "get_config"]

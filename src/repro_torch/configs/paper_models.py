"""The paper's five benchmark models, copied field for field from the
reference package's configs/paper_models.py: classic MHA, LayerNorm, GELU
MLP.

ViT-{B,L,H}: encoder-only classifiers (S = 197 = 196 patches + the cls
token), bidirectional attention, no rotary positions (learned ones).
GPT3-XL / GPT-J: decoder-only LLMs with rotary positions, NAR (prefill) +
AR (decode) modes."""
from repro_torch.configs.base import ModelConfig, uniform_schedule


def _vit(name, blocks, E, P, FF, H):
    return ModelConfig(
        name=name, family="vit",
        n_layers=blocks, d_model=E, n_heads=H, n_kv_heads=H, head_dim=P,
        d_ff=FF, vocab=0,
        schedule=uniform_schedule("vit", blocks),
        mlp_act="gelu", norm="layernorm", causal=False,
        rope_theta=0.0,
        n_classes=1000, image_seq=197,
        attention_sharding="seq_sp",
        max_seq=256,
    )


VIT_B = _vit("vit-b", 12, 768, 64, 3072, 12)
VIT_L = _vit("vit-l", 24, 1024, 64, 4096, 16)
VIT_H = _vit("vit-h", 32, 1280, 80, 5120, 16)


def _gpt(name, blocks, E, P, FF, H, vocab):
    return ModelConfig(
        name=name, family="dense",
        n_layers=blocks, d_model=E, n_heads=H, n_kv_heads=H, head_dim=P,
        d_ff=FF, vocab=vocab,
        schedule=uniform_schedule("attn", blocks),
        mlp_act="gelu", norm="layernorm",
        rope_theta=10_000.0,
        attention_sharding="head_tp",
        max_seq=2048,
    )


GPT3_XL = _gpt("gpt3-xl", 40, 2048, 128, 8192, 16, 50_257)
GPT_J = _gpt("gpt-j", 28, 4096, 256, 16_384, 16, 50_400)

PAPER_MODELS = {m.name: m
                for m in (VIT_B, VIT_L, VIT_H, GPT3_XL, GPT_J)}

"""The paper's decoder-only benchmark models (GPT3-XL, GPT-J), copied from
the reference package's configs/paper_models.py: classic MHA, LayerNorm,
GELU MLP, rotary positions."""
from repro_torch.configs.base import ModelConfig, uniform_schedule


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

PAPER_MODELS = {m.name: m for m in (GPT3_XL, GPT_J)}

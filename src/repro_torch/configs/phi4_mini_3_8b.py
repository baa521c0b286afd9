"""phi4-mini-3.8b  [dense]  32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA  [arXiv:2412.08905; hf]

A copy of the reference package's configs/phi4_mini_3_8b.py (the port
imports nothing from it; `tests/test_torch_phi4.py` checks the copy field
for field)."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200_064,
    schedule=uniform_schedule("attn", 32),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention_sharding="seq_sp",
)

"""mixtral-8x7b  [moe]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA  [arXiv:2401.04088; hf]

A copy of the reference package's configs/mixtral_8x7b.py (the port
imports nothing from it; `tests/test_torch_moe.py` checks the copy field
for field)."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab=32_000,
    schedule=uniform_schedule("moe_local", 32),
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    attention_sharding="head_tp",
)

"""deepseek-67b  [dense]  95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch  [arXiv:2401.02954; hf]

A copy of the reference package's configs/deepseek_67b.py (the port
imports nothing from it; `tests/test_torch_dense.py` checks the copy field
for field).  Its bf16 weights (134.9 GB) exceed one 80 GB card: the CLI
refuses it whole and serves it with `--reduced`."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    vocab=102_400,
    schedule=uniform_schedule("attn", 95),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention_sharding="head_tp",
)

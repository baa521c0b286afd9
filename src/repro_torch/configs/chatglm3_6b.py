"""chatglm3-6b  [dense]  28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA  [arXiv:2406.12793; hf]

2d-RoPE: only half the head dims are rotated (rope_fraction=0.5).  32
query heads over 2 kv heads: 16 query heads a kv head, the decode
kernels' G = 16 form.  A copy of the reference package's
configs/chatglm3_6b.py (the port imports nothing from it;
`tests/test_torch_dense.py` checks the copy field for field)."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13_696,
    vocab=65_024,
    schedule=uniform_schedule("attn", 28),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    rope_fraction=0.5,
    attention_sharding="head_tp",
)

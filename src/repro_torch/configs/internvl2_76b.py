"""internvl2-76b  [vlm]  80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2  [arXiv:2404.16821; unverified]

The backbone only: the InternViT frontend is a stub (`models/frontends.py`)
that supplies precomputed patch embeddings (n_patches x d_model), placed
in front of the token embeddings.  A copy of the reference package's
configs/internvl2_76b.py (the port imports nothing from it;
`tests/test_torch_dense.py` checks the copy field for field).  Its bf16
weights (141.1 GB) exceed one 80 GB card: the CLI refuses it whole and
serves it with `--reduced`."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab=128_256,
    schedule=uniform_schedule("attn", 80),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    n_patches=256,
    attention_sharding="head_tp",
)

"""mixtral-8x22b  [moe]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA  [arXiv:2401.04088; hf]

Window 4096 per the Mixtral SWA design.  A copy of the reference
package's configs/mixtral_8x22b.py (the port imports nothing from it;
`tests/test_torch_moe.py` checks the copy field for field)."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab=32_768,
    schedule=uniform_schedule("moe_local", 56),
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    attention_sharding="head_tp",
)

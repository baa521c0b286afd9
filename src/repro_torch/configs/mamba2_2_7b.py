"""mamba2-2.7b  [ssm]  64L d_model=2560 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality)  [arXiv:2405.21060; unverified]

Attention-free: every layer is a Mamba2 SSD block.  A copy of the reference
package's configs/mamba2_2_7b.py (the port imports nothing from it;
`tests/test_torch_hybrid.py` checks the copy field for field)."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50_280,
    schedule=uniform_schedule("ssm", 64),
    ssm_state=128,
    ssm_head_dim=64,
    d_inner=5120,
    conv_width=4,
    norm="rmsnorm",
    causal=True,
    attention_sharding="seq_sp",
)

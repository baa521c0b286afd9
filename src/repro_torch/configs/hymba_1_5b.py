"""hymba-1.5b  [hybrid]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads  [arXiv:2411.13676; hf]

Every layer runs attention and SSM heads in parallel on the same input and
averages the two outputs.  Layers {0, 15, 31} use global attention, the
rest a 1024-token sliding window.  A copy of the reference package's
configs/hymba_1_5b.py (the port imports nothing from it;
`tests/test_torch_hybrid.py` checks the copy field for field)."""
from repro_torch.configs.base import ModelConfig

SCHEDULE = (
    ("hybrid_attn", 1), ("hybrid_local", 14),
    ("hybrid_attn", 1), ("hybrid_local", 15),
    ("hybrid_attn", 1),
)

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32_001,
    schedule=SCHEDULE,
    sliding_window=1024,
    ssm_state=16,
    ssm_head_dim=64,
    d_inner=3200,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    attention_sharding="seq_sp",
)

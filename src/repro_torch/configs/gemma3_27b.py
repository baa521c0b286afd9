"""gemma3-27b  [dense]  62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local:global, 128k  [hf:google/gemma-3-1b-pt; unverified]

Schedule: (5 sliding-window + 1 global) x 10 + 2 trailing local layers = 62.
Local window 1024 (gemma3 default): local layers keep a window-bounded ring
cache, the 10 global layers their full-length KV in the block pool.  A copy
of the reference package's configs/gemma3_27b.py (the port imports nothing
from it; `tests/test_torch_window.py` checks the copy field for field)."""
from repro_torch.configs.base import ModelConfig

SCHEDULE = (("local", 5), ("attn", 1)) * 10 + (("local", 2),)

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab=262_144,
    schedule=SCHEDULE,
    sliding_window=1024,
    mlp_act="gelu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    attention_sharding="head_tp",
)

"""whisper-base  [audio]  6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder, conv frontend (stub)  [arXiv:2212.04356; unverified]

The backbone only: the conv / mel frontend is a stub (`models/frontends.py`)
that supplies precomputed frame embeddings (enc_seq x d_model, padded to
`enc_seq_padded` = 1504 rows).  6 encoder layers (bidirectional) over the
frames, then 6 decoder layers (causal self-attention, then cross-attention
over the encoder's output); sinusoidal absolute positions, no rope.  A
copy of the reference package's configs/whisper_base.py (the port imports
nothing from it; `tests/test_torch_whisper.py` checks the copy field for
field).  It has no speculative draft, as in the reference."""
from repro_torch.configs.base import ModelConfig, uniform_schedule

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51_865,
    schedule=uniform_schedule("dec", 6),
    enc_schedule=uniform_schedule("enc", 6),
    n_enc_layers=6,
    enc_seq=1500,
    mlp_act="gelu",
    norm="layernorm",
    rope_theta=0.0,          # sinusoidal absolute positions
    attention_sharding="seq_sp",
)

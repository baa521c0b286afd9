"""Modality frontend stubs (port of the reference's models/frontends.py).

A VLM config (`n_patches` > 0: internvl2-76b) serves its transformer
backbone only: the InternViT patch encoder is a stub, and its output, one
d_model-wide embedding a patch, is an input of the prefill and encode
passes, placed at positions [0, n_patches) in front of the prompt's
tokens (`models/lm.py:_embed_sequence`).  An encoder-decoder
(`enc_schedule`: whisper-base) serves its backbone the same way: the conv
/ mel frontend is a stub, and its output, `enc_seq` frame embeddings
padded with zero rows to `enc_seq_padded`, is the encoder's input
(`models/lm.py:_run_encoder`).  `serving_patches` and `serving_frames`
give the zero rows the serving runner passes (as the reference's runner
does), `make_batch` a seeded synthetic batch, drawn with numpy exactly as
the reference draws it.
"""
from __future__ import annotations

import numpy as np
import torch

EMBED_DTYPE = torch.bfloat16


def serving_patches(cfg, n: int, *, device):
    """The patch rows of n served sequences: zeros [n, n_patches, d_model]
    at EMBED_DTYPE (None for a config without a patch prefix)."""
    if not cfg.n_patches:
        return None
    return torch.zeros((n, cfg.n_patches, cfg.d_model), dtype=EMBED_DTYPE,
                       device=device)


def serving_frames(cfg, n: int, *, device):
    """The frame rows of n served sequences: zeros [n, enc_seq_padded,
    d_model] at EMBED_DTYPE (None for a config without an encoder)."""
    if not cfg.enc_schedule:
        return None
    return torch.zeros((n, cfg.enc_seq_padded, cfg.d_model),
                       dtype=EMBED_DTYPE, device=device)


def make_batch(cfg, global_batch: int, seq_len: int, *, seed: int = 0,
               device="cpu") -> dict:
    """A deterministic synthetic prefill batch of `seq_len` positions (the
    patch prefix included): tokens uniform in [0, vocab), patches standard
    normal rounded to EMBED_DTYPE, an encoder-decoder's frames standard
    normal in the first enc_seq rows and zero in the padding rows after
    them, rounded to EMBED_DTYPE, from `np.random.default_rng(seed)` in
    the reference's order (its `make_batch(cfg, "prefill", ...)`), so the
    same seed gives the same batch."""
    rng = np.random.default_rng(seed)
    s_text = seq_len - (cfg.n_patches or 0)
    toks = rng.integers(0, max(cfg.vocab, 2), (global_batch, s_text + 1),
                        dtype=np.int32)
    out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device)}
    if cfg.n_patches:
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (global_batch, cfg.n_patches, cfg.d_model), dtype=np.float32)
        ).to(device=device, dtype=EMBED_DTYPE)
    if cfg.enc_schedule:
        frames = np.zeros((global_batch, cfg.enc_seq_padded, cfg.d_model),
                          np.float32)
        frames[:, :cfg.enc_seq] = rng.standard_normal(
            (global_batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        out["frames"] = torch.from_numpy(frames).to(device=device,
                                                    dtype=EMBED_DTYPE)
    return out

"""Deterministic, step-indexed data pipeline (port of the reference's
data/pipeline.py).

Restart-exact: batch(step) is a pure function of (seed, step, host), so a
run restored at step k continues bit for bit as the uninterrupted one (the
fault-tolerance contract of `runtime/fault_tolerance.py`).  The draws are
the reference's own `np.random.SeedSequence([seed, step, host])` streams,
so a batch is bit-equal to the reference's.  Two sources:

  SyntheticStream  hash-seeded token batches
  FileStream       a binary token file (uint16 / uint32) through np.memmap,
                   sharded by host and strided by step

Both emit torch tensors on the stream's device (the GPU unless
device="cpu"): tokens / labels int32, a VLM's stub patch embeddings and an
encoder-decoder's stub frames bf16, as the reference's are.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _bf16(arr, device):
    return torch.from_numpy(arr).to(device=device, dtype=torch.bfloat16)


def _tokens(toks, kind, device):
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])
                                      ).to(device)}
    if kind == "train":
        out["labels"] = torch.from_numpy(np.ascontiguousarray(toks[:, 1:])
                                         ).to(device)
    return out


class SyntheticStream:
    def __init__(self, cfg, *, global_batch: int, seq_len: int,
                 seed: int = 0, kind: str = "train", host_id: int = 0,
                 n_hosts: int = 1, device=None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.kind = kind
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        s_text = self.seq_len - (cfg.n_patches or 0)
        b = self.global_batch // self.n_hosts
        toks = rng.integers(0, max(cfg.vocab, 2), (b, s_text + 1),
                            dtype=np.int32)
        out = _tokens(toks, self.kind, self.device)
        if cfg.n_patches:
            out["patches"] = _bf16(rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model), dtype=np.float32),
                self.device)
        if cfg.enc_schedule:
            fr = np.zeros((b, cfg.enc_seq_padded, cfg.d_model), np.float32)
            fr[:, :cfg.enc_seq] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)
            out["frames"] = _bf16(fr, self.device)
        return out


class FileStream:
    """Binary token file -> LM batches.  The file is one flat token array;
    batch(step) reads a deterministic window: restart-exact and
    host-sharded."""

    def __init__(self, cfg, path: str, *, global_batch: int, seq_len: int,
                 dtype=np.uint16, kind: str = "train", host_id: int = 0,
                 n_hosts: int = 1, device=None):
        self.cfg = cfg
        self.path = path
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.kind = kind
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        need = (global_batch // n_hosts) * (seq_len + 1)
        if len(self.tokens) < need:
            raise ValueError(f"{path}: {len(self.tokens)} tokens < one batch "
                             f"({need})")

    def batch(self, step: int) -> dict:
        b = self.global_batch // self.n_hosts
        width = self.seq_len + 1
        n_windows = len(self.tokens) // width
        rows = []
        for i in range(b):
            w = (step * self.global_batch + self.host_id * b + i) % n_windows
            rows.append(np.asarray(self.tokens[w * width:(w + 1) * width],
                                   dtype=np.int32))
        toks = np.clip(np.stack(rows), 0, self.cfg.vocab - 1)
        return _tokens(toks, self.kind, self.device)


def make_stream(cfg, *, global_batch: int, seq_len: int,
                path: Optional[str] = None, seed: int = 0,
                kind: str = "train", device=None):
    if path and os.path.exists(path):
        return FileStream(cfg, path, global_batch=global_batch,
                          seq_len=seq_len, kind=kind, device=device)
    return SyntheticStream(cfg, global_batch=global_batch, seq_len=seq_len,
                           seed=seed, kind=kind, device=device)

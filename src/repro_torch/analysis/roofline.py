"""Analytic FLOPs and achieved utilization on the H100 (port of the
reference's analysis/roofline.py, less its HLO roofline: `Roofline` and
`roofline_from_summary` read XLA's compiled HLO, which has no torch twin).

  decoder_flops_per_token  forward FLOPs a token position, 2 x N_active,
                           embedding tables excluded
  model_flops              the same for a whole train / prefill / decode
                           step shape
  utilization              (MFU, MBU) of an interval against the card's
                           peaks

`EngineStats.phase_util` and `serving/trace.py:derive_phase_metrics` turn a
serving phase's (time, token positions, weight passes, KV positions) into
MFU / MBU with these.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM5 80 GB data sheet: dense BF16 tensor-core throughput
# (989.4 TFLOP/s without sparsity) and HBM3 bandwidth (3.35 TB/s); the
# constants chip_smoke.py's bounds use
PEAK_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12            # B/s


def decoder_flops_per_token(cfg) -> float:
    """Analytic forward FLOPs per token position: 2 * N_active, embedding
    tables excluded (the per-token factor `model_flops` scales by token
    count)."""
    n = cfg.n_active_params()
    n -= cfg.padded_vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 2.0 * n


def utilization(flops: float, mem_bytes: float, time_s: float, *,
                peak_flops: float = PEAK_BF16,
                hbm_bw: float = HBM_BW) -> Tuple[float, float]:
    """(MFU, MBU) of an interval: achieved FLOP/s and HBM bytes/s as a
    fraction of the card's peaks; (0, 0) for an empty interval."""
    if time_s <= 0:
        return 0.0, 0.0
    return flops / (time_s * peak_flops), mem_bytes / (time_s * hbm_bw)


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs of a whole step of `shape`
    (`configs.base.ShapeConfig`): train 6 * N_active * D tokens, prefill
    2 * N_active * D, decode 2 * N_active * B (a token a sequence); N
    excludes the embedding tables."""
    n = decoder_flops_per_token(cfg) / 2.0
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch

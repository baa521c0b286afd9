"""Paged KV-cache layout (port of the reference's launch/steps.py
`PagedLayout`, `make_paged_layout` and the paged branch of `cache_layout`).

The reference builds jitted step functions here; PyTorch runs eagerly, so
the port keeps only the layout and allocates the pools directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import blocks
from repro_torch.core.attention import CACHE_DTYPE


@dataclass(frozen=True)
class PagedLayout:
    """Pools are [count, num_blocks + 1, block_size, KV, hd] per paged
    segment — the extra trailing block is the write sink for dropped
    writes; one [B, max_blocks] block table addresses every layer."""
    num_blocks: int
    block_size: int
    max_blocks: int                     # table width: ceil(max_seq / bs)
    segments: tuple                     # per-segment bool: k/v are pools


def make_paged_layout(cfg, max_seq: int, num_blocks: int,
                      block_size: int) -> PagedLayout:
    return PagedLayout(
        num_blocks=num_blocks, block_size=block_size,
        max_blocks=-(-max_seq // block_size),
        segments=tuple(blocks.kind_paged(kind, cfg, max_seq)
                       for kind, _ in cfg.schedule))


def cache_layout(cfg, layout: PagedLayout, *, device):
    """Zeroed decode caches: one {"k", "v"} pool dict per segment."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    out = []
    for (kind, count), paged in zip(cfg.schedule, layout.segments):
        if not paged:
            raise NotImplementedError(
                f"segment kind {kind!r} needs a dense cache, not ported yet")
        shape = (count, layout.num_blocks + 1, layout.block_size, KV, hd)
        out.append({"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
                    "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device)})
    return tuple(out)

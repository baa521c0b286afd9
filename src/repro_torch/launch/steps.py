"""Decode-cache layout (port of the reference's launch/steps.py
`PagedLayout`, `make_paged_layout` and `cache_layout`, paged layout: block
pools for full-context attention, dense ring caches for window layers
shorter than max_seq, per-slot SSM state).

The reference builds jitted step functions here; PyTorch runs eagerly, so
the port keeps only the layout and allocates the caches directly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ATTN_KINDS, SSM_KINDS
from repro_torch.core import blocks
from repro_torch.core.nn import act_dtype


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


def cache_layout(cfg, layout: PagedLayout, *, batch_size: int, policy,
                 device):
    """Zeroed decode caches, one dict per segment: paged attention kinds
    get {"k", "v"} block pools; window layers shorter than max_seq get
    dense per-slot ring caches "k" / "v" [count, B, window, KV, hd]; both
    in the activation dtype.  SSM kinds get per-slot dense state, "h"
    [count, B, Hp, P, N] fp32 and the conv tails "cx" [count, B, cw - 1,
    d_inner] / "cbc" [count, B, cw - 1, 2N] in the activation dtype."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    Hp, P, N = cfg.padded_ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state
    cw, dip = cfg.conv_width, cfg.padded_d_inner()
    ad = act_dtype(policy)
    B = batch_size
    out = []
    for (kind, count), paged in zip(cfg.schedule, layout.segments):
        d = {}
        if kind in ATTN_KINDS:
            rows = ((layout.num_blocks + 1, layout.block_size) if paged
                    else (B, blocks.kind_window(kind, cfg)))
            shape = (count, *rows, KV, hd)
            d["k"] = torch.zeros(shape, dtype=ad, device=device)
            d["v"] = torch.zeros(shape, dtype=ad, device=device)
        if kind in SSM_KINDS:
            d["h"] = torch.zeros((count, B, Hp, P, N), dtype=torch.float32,
                                 device=device)
            d["cx"] = torch.zeros((count, B, cw - 1, dip), dtype=ad,
                                  device=device)
            d["cbc"] = torch.zeros((count, B, cw - 1, 2 * N), dtype=ad,
                                   device=device)
        out.append(d)
    return tuple(out)

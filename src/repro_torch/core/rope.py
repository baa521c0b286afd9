"""Rotary position embeddings, GPT-J style: INTERLEAVED pairs
(x[..., 0::2], x[..., 1::2]) rotate together, not the half-split layout of
NeoX-style code.  Positions are explicit so decode steps rotate correctly.
`sinusoidal_positions` is the absolute table of a config without rope
(rope_theta == 0: whisper-base), added to the residual stream instead.
"""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, *, theta: float, fraction: float = 1.0):
    """x: [B, S, H, D]; positions: [S] or [B, S] integer."""
    if theta <= 0:
        return x
    D = x.shape[-1]
    inv, rot = rope_freqs(D, fraction, theta, device=x.device)
    if rot == 0:
        return x
    pos = positions.to(torch.float32)
    if pos.ndim == 1:
        ang = (pos[:, None] * inv[None, :])[None, :, None, :]   # [1,S,1,r/2]
    else:
        ang = (pos[:, :, None] * inv[None, None, :])[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rotated = torch.stack([r1, r2], dim=-1).reshape(x[..., :rot].shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def sinusoidal_positions(n: int, d: int, offset=0, device=None):
    """The classic transformer sinusoidal table [n, d] fp32 (whisper-style,
    the reference's): row p holds sin(p * f_i) for i < d // 2, then
    cos(p * f_i), concatenated (not interleaved), with frequencies
    f_i = exp(-ln(1e4) * i / max(d // 2 - 1, 1)); an odd d gives d - 1
    columns, as the reference's table does."""
    pos = torch.arange(n, dtype=torch.float32, device=device) + offset
    half = d // 2
    # -ln(1e4) enters as an fp32 scalar, as the reference's does
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]

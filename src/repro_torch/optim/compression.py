"""Symmetric int8 quantization with fp32 scales (copy of the reference's
`optim/compression.quantize_int8_axiswise`, the one piece of that module
the port serves with): per-output-channel for the weight-only int8 GEMMs
(`models/quantize.py`) and the rule the int8 paged KV pools quantize by
(`core/attention.py`, `serving/kv_cache.py`)."""
from __future__ import annotations

import torch


def quantize_int8_axiswise(x, axis=None):
    """Symmetric int8 with one fp32 scale per index along `axis`.

    `axis=None` gives one scale for the tensor; an int or a tuple of ints
    keeps those axes and takes the amax over all others.  scale =
    max(amax, 1e-30) / 127, q = clip(round(x / scale), -127, 127) with
    round half to even (as `jnp.round`).  -> (q int8 of x's shape, scale
    fp32 of x's shape restricted to the `axis` dims)."""
    xf = x.float()
    if axis is None:
        reduce_axes = tuple(range(xf.ndim))
    else:
        keep = {a % xf.ndim for a in
                (axis if isinstance(axis, tuple) else (axis,))}
        reduce_axes = tuple(a for a in range(xf.ndim) if a not in keep)
    amax = xf.abs().amax(dim=reduce_axes) if reduce_axes else xf.abs()
    scale = torch.clamp(amax, min=1e-30) / 127.0   # a zero slice: finite
    s_b = scale
    for a in reduce_axes:
        s_b = s_b.unsqueeze(a)
    q = torch.clamp(torch.round(xf / s_b), -127, 127).to(torch.int8)
    return q, scale


__all__ = ["quantize_int8_axiswise"]

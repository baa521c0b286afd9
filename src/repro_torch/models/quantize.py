"""Weight-only int8 quantization of the LM parameter tree (port of the
reference's models/quantize.py).

One pass after the weights load, for serving: every dense GEMM weight —
the attention projections (wq / wk / wv / wo), the MLP weights (wg / wu /
w1 / w2) and the logits head (`embedding/unemb`) — becomes

    {"q": int8 (the weight's shape), "scale": fp32 [.., N]}

with one symmetric scale per output channel (`quantize_int8_axiswise`
over everything but the contraction dim).  The GEMM entry points of
`kernels/ops.py` take the dict (`split_quantized`) and apply the scale to
the fp32 accumulator, so the int8 tensor is what a kernel reads.

Left as they are: the embedding table (a gather, not a GEMM), the norms,
the SSM parameters and MoE leaves (4-D stacks, excluded by rank).
`quantize_param_dims` (sharding specs) is not ported: the port runs on
one device.
"""
from __future__ import annotations

import torch

from repro_torch.optim.compression import quantize_int8_axiswise

# dense-GEMM leaf names inside a (stacked) block param dict; MoE leaves
# reuse wg / wu / w2 but are 4-D stacks [L, NE, ., .], excluded by rank
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "w1", "w2"})
_STACKED_RANK = 3          # [L, K, N]: a segment's stacked dense weights


def _quantize_leaf(w):
    """[.., K, N] -> {"q": int8 of w's shape, "scale": fp32 [.., N]}: one
    scale per output column, the amax over the contraction dim K (-2).  A
    stacked leaf is quantized a layer at a time (the same values), so that
    the fp32 temporaries stay one layer's size."""
    if w.ndim > 2:
        parts = [_quantize_leaf(wi) for wi in w]
        return {"q": torch.stack([p["q"] for p in parts]),
                "scale": torch.stack([p["scale"] for p in parts])}
    q, scale = quantize_int8_axiswise(w, axis=(1,))
    return {"q": q, "scale": scale}


def _quantize_block(node, name=None):
    if isinstance(node, dict):
        return {k: _quantize_block(v, k) for k, v in node.items()}
    if (name in QUANT_KEYS and getattr(node, "ndim", 0) == _STACKED_RANK
            and node.is_floating_point()):
        return _quantize_leaf(node)
    return node


def quantize_params(params: dict) -> dict:
    """The LM parameter tree (`models/lm.init_lm` layout) -> the same tree
    with every dense GEMM weight replaced by its {"q", "scale"} pair (new
    tensors; the input tree is not changed)."""
    out = dict(params)
    emb = dict(params["embedding"])
    emb["unemb"] = _quantize_leaf(params["embedding"]["unemb"])
    out["embedding"] = emb
    for key in ("segments", "enc_segments"):
        if key in params:
            out[key] = tuple(_quantize_block(seg) for seg in params[key])
    return out


__all__ = ["QUANT_KEYS", "quantize_params"]

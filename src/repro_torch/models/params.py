"""Parameter-tree helpers shared by the port's model forwards: the numpy
converter behind `lm.params_from_numpy` / `vit.vit_params_from_numpy`, and the
per-layer view of a stacked segment."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_from_numpy(tree, shapes, *, dtype=torch.float32, device=None):
    """A parameter tree of numpy leaves -> torch tensors at `dtype`, checked
    leaf for leaf against the shape tree `shapes` (dicts, tuples of segment
    dicts, shape tuples).  A weight-only int8 leaf ({"q", "scale"},
    `models/quantize.py`) keeps its int8 q and fp32 scale."""
    dev = resolve_device(device)

    def conv(node, shape_node, path):
        if isinstance(shape_node, dict):
            if not isinstance(node, dict) or set(node) != set(shape_node):
                raise ValueError(f"params_from_numpy: {path or 'root'} has "
                                 f"keys {sorted(node)}, expected "
                                 f"{sorted(shape_node)}")
            return {k: conv(node[k], shape_node[k], f"{path}/{k}")
                    for k in shape_node}
        if isinstance(shape_node, tuple) and shape_node and isinstance(
                shape_node[0], dict):
            if len(node) != len(shape_node):
                raise ValueError(f"params_from_numpy: {path} has "
                                 f"{len(node)} segments, expected "
                                 f"{len(shape_node)}")
            return tuple(conv(n, s, f"{path}[{i}]")
                         for i, (n, s) in enumerate(zip(node, shape_node)))
        if isinstance(node, dict):
            return quantized(node, tuple(shape_node), path)
        arr = np.asarray(node, np.float32)
        if arr.shape != tuple(shape_node):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{arr.shape}, expected {tuple(shape_node)}")
        return torch.tensor(arr, device=dev).to(dtype)

    def quantized(node, shape, path):
        # a weight-only int8 leaf: q stays int8, the scale fp32 [.., N]
        if set(node) != {"q", "scale"}:
            raise ValueError(f"params_from_numpy: {path} has keys "
                             f"{sorted(node)}, expected a weight or "
                             f"['q', 'scale']")
        q, scale = np.asarray(node["q"]), np.asarray(node["scale"])
        want = (shape, shape[:-2] + shape[-1:])
        if q.dtype != np.int8 or (q.shape, scale.shape) != want:
            raise ValueError(f"params_from_numpy: {path} is int8 {q.dtype} "
                             f"{q.shape} / scale {scale.shape}, expected "
                             f"int8 {want[0]} / {want[1]}")
        return {"q": torch.tensor(q, device=dev),
                "scale": torch.tensor(scale.astype(np.float32), device=dev)}

    return conv(tree, shapes, "")


def layer(p_seg, i):
    """Layer `i`'s parameter (or cache) views from a stacked segment."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in p_seg.items()}


__all__ = ["tree_from_numpy", "layer"]

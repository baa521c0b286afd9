"""Parameter-tree helpers shared by the port's model forwards: the numpy
converter behind `lm.params_from_numpy` / `vit.vit_params_from_numpy`, the
per-layer view of a stacked segment, and the tree walk of the optimizer and
the checkpointer (`tree_flatten` / `tree_unflatten`), whose leaf order is
`jax.tree.flatten`'s: dict keys sorted, tuples and lists in order, None an
empty subtree.  A checkpoint's leaf i is then the same leaf in both
packages."""
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


def layers(p_seg, count: int):
    """Every layer's parameter views of a stacked segment, one `unbind` a
    leaf: under autograd the layers' gradients stack once into the
    segment's (indexing layer by layer would add each into a zero tensor
    of the whole stack)."""
    def split(tree):
        return {k: (split(v) if isinstance(v, dict) else torch.unbind(v))
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: (pick(v, i) if isinstance(v, dict) else v[i])
                for k, v in tree.items()}

    parts = split(p_seg)
    return [pick(parts, i) for i in range(count)]


def meta_tree(shapes, dtype=torch.float32):
    """"meta" tensors (no storage) at `dtype` of a shape tree (dicts,
    tuples of segment dicts, shape tuples): the like-tree a checkpoint
    restores into."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v, dtype) for k, v in shapes.items()}
    if shapes and isinstance(shapes[0], dict):
        return tuple(meta_tree(v, dtype) for v in shapes)
    return torch.empty(shapes, dtype=dtype, device="meta")


class TreeDef:
    """The structure of a flattened tree; `str` gives `jax.tree`'s treedef
    form (`PyTreeDef({'a': *, 'b': (*, *)})`), which checkpoint manifests
    record."""

    def __init__(self, node):
        self.node = node

    def __repr__(self):
        def fmt(n):
            kind, sub = n
            if kind == "leaf":
                return "*"
            if kind == "none":
                return "None"
            if kind == "dict":
                return "{" + ", ".join(f"{k!r}: {fmt(v)}"
                                       for k, v in sub) + "}"
            inner = ", ".join(fmt(v) for v in sub)
            if kind == "tuple":
                return f"({inner},)" if len(sub) == 1 else f"({inner})"
            return f"[{inner}]"
        return f"PyTreeDef({fmt(self.node)})"


def tree_flatten(tree):
    """-> (leaves, TreeDef) in `jax.tree.flatten`'s order."""
    leaves = []

    def walk(n):
        if n is None:
            return ("none", None)
        if isinstance(n, dict):
            return ("dict", [(k, walk(n[k])) for k in sorted(n)])
        if isinstance(n, (tuple, list)):
            kind = "tuple" if isinstance(n, tuple) else "list"
            return (kind, [walk(v) for v in n])
        leaves.append(n)
        return ("leaf", None)

    return leaves, TreeDef(walk(tree))


def tree_unflatten(treedef: TreeDef, leaves):
    """The tree of `treedef` with `leaves` in flatten order."""
    it = iter(leaves)

    def build(n):
        kind, sub = n
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(v) for k, v in sub}
        out = [build(v) for v in sub]
        return tuple(out) if kind == "tuple" else out

    out = build(treedef.node)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn, tree):
    """`fn` over the leaves of `tree`, in a tree of the same structure."""
    leaves, tdef = tree_flatten(tree)
    return tree_unflatten(tdef, [fn(x) for x in leaves])


__all__ = ["tree_from_numpy", "layer", "layers", "meta_tree", "TreeDef",
           "tree_flatten", "tree_unflatten", "tree_map"]

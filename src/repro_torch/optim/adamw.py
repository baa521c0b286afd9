"""AdamW on one device (port of the reference's optim/adamw.py).

The update is the reference's formula in its order (b1 0.9, b2 0.95, eps
1e-8, weight decay 0.1 on every leaf, bias correction from step + 1), one
leaf at a time in `tree_flatten` order; it is not `torch.optim.AdamW`,
which orders the same update otherwise.  `adamw_update` writes the new
params, m and v into their tensors in place and returns the same trees:
the reference's train step donates its state, and at GPT3-XL's size a
second copy of the fp32 params, m and v (26.6 GB) would not fit beside
the step's activations.  `shard_axes` is accepted for the reference's
signature; on one device every leaf counts once.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_flatten, tree_map, tree_unflatten


def adamw_init(params):
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)}


def global_grad_norm(grads, shard_axes=None):
    """sqrt of the sum over leaves of sum(g * g) in fp32."""
    leaves = tree_flatten(grads)[0]
    if shard_axes is not None and len(shard_axes) != len(leaves):
        raise ValueError(f"global_grad_norm: {len(shard_axes)} shard_axes "
                         f"for {len(leaves)} leaves")
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        gf = g.float()
        total = total + torch.sum(gf * gf)
    return torch.sqrt(total)


def clip_by_global_norm(grads, shard_axes, max_norm: float):
    """-> (grads * min(1, max_norm / max(norm, 1e-9)) in fp32, norm)."""
    norm = global_grad_norm(grads, shard_axes)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, opt, *, step, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """params / grads / opt["m" | "v"]: matching trees of fp32 tensors;
    `step` and `lr` scalars (tensors or numbers).  Updates params, m and v
    in place -> (params, opt)."""
    p0 = tree_flatten(params)[0][0]
    stepf = torch.as_tensor(step, device=p0.device).to(torch.float32) + 1.0
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, device=p0.device).to(torch.float32)
    flat_p, tdef = tree_flatten(params)
    flat_g = tree_flatten(grads)[0]
    flat_m = tree_flatten(opt["m"])[0]
    flat_v = tree_flatten(opt["v"])[0]
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)                  # b1 m + (1 - b1) g
        v.mul_(b2).add_((1 - b2) * g * g)              # b2 v + (1 - b2) g g
        upd = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
        upd.add_(weight_decay * p)
        p.sub_(lr * upd)
    return (tree_unflatten(tdef, flat_p),
            {"m": opt["m"], "v": opt["v"]})

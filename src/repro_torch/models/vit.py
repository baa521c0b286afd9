"""Encoder-only ViT classifier (port of the reference's models/vit.py): the
paper's own model family.

The patchify frontend (a stride = kernel 16 x 16 x 3 convolution) is a
linear map on flattened patches, so it runs as one GEMM (`pdot`), followed
by the cls token, learned positions, the `vit` blocks (bidirectional
attention + GELU MLP), the final LayerNorm and the classifier head,
[B, E] @ [E, n_classes] in fp32 plus its bias.  One pass per
classification (the paper's images/s metric).

Parameters keep the reference's tree: `patch`, `cls`, `pos`, `head`,
`head_b`, `final_norm/{scale, bias}` and one dict per schedule segment
with the layer dim first, as in `models.lm`.

`vit_loss` is the classifier's training loss (the reference's): the
log-softmax cross-entropy of the fp32 logits (head bias included) and the
accuracy.  Under autograd the forward's GEMMs, flash attention and
LayerNorm run their kernels' autograd Functions (`kernels/ops.py`); the
layers are not rematerialized, as the reference's are not.
"""
from __future__ import annotations

import torch

from repro_torch.core import blocks
from repro_torch.core.nn import fused_pdot, pdot
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.models.lm import lm_param_shapes
from repro_torch.models.params import layer, tree_from_numpy

PATCH_DIM = 16 * 16 * 3


def vit_param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (segment leaves with the layer dim
    leading)."""
    E = cfg.d_model
    return {
        "patch": (PATCH_DIM, E), "cls": (1, E), "pos": (cfg.image_seq, E),
        "head": (E, cfg.n_classes), "head_b": (cfg.n_classes,),
        "final_norm": blocks.norm_shapes(cfg),
        "segments": lm_param_shapes(cfg)["segments"],
    }


def init_vit(cfg, *, dtype=torch.bfloat16, device=None, seed: int = 0):
    """Random N(0, 0.02) weights (unit / zero norms, zero head bias) from a
    seeded `torch.Generator`, made on the device (the GPU unless
    device="cpu")."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    segs = tuple(blocks.init_block(gen, kind, cfg, dtype, dev, count)
                 for kind, count in cfg.schedule)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02
                ).to(dtype)

    shapes = vit_param_shapes(cfg)
    out = {k: normal(shapes[k]) for k in ("patch", "cls", "pos", "head")}
    out.update(head_b=torch.zeros(shapes["head_b"], dtype=dtype, device=dev),
               final_norm=blocks.init_norm(cfg, dtype, dev), segments=segs)
    return out


def vit_params_from_numpy(tree, cfg, *, dtype=torch.float32, device=None):
    """The reference's ViT tree (leaves as numpy arrays, e.g.
    `jax.tree.map(np.asarray, vit.init_vit(...))`) -> the port's
    parameters; raises on a missing leaf or a shape that does not match
    `cfg`."""
    return tree_from_numpy(tree, vit_param_shapes(cfg), dtype=dtype,
                           device=device)


def forward_vit(params, patches, *, cfg, policy, fused: bool = True):
    """patches: [B, n_patches, PATCH_DIM] raw pixels -> logits
    [B, n_classes] fp32.  `fused`: the blocks' norm prologues and residual
    epilogues inside the GEMMs, and the final norm folded into the head
    GEMM's prologue on the cls row alone (the norm is row-wise, so
    select-then-norm equals norm-then-select) with the head bias in its
    epilogue; unfused: the reference's chain, the final norm over every
    row, then the head and the bias add."""
    B = patches.shape[0]
    x = pdot(patches, params["patch"], policy)          # linear patchify
    E = x.shape[-1]
    cls = params["cls"][None].expand(B, 1, E).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos"][None, :x.shape[1]].to(x.dtype)
    for (kind, count), p_seg in zip(cfg.schedule, params["segments"]):
        for i in range(count):
            x, _ = blocks.block_full(kind, layer(p_seg, i), x, cfg=cfg,
                                     policy=policy, fused=fused)
    if fused:
        return fused_pdot(
            x[:, 0], params["head"], policy,
            prologue=ops.norm_prologue(params["final_norm"], cfg.norm),
            epilogue=Epilogue(bias=params["head_b"]), out_dtype=torch.float32)
    x = ops.norm(x, params["final_norm"], cfg.norm)
    logits = pdot(x[:, 0], params["head"], policy, out_dtype=torch.float32)
    return logits + params["head_b"].to(torch.float32)


def vit_loss(params, patches, labels, *, cfg, policy, fused: bool = True):
    """patches: [B, n_patches, PATCH_DIM]; labels: [B] class ids ->
    (loss, {"loss", "acc"}): the mean of -log_softmax(logits)[label] and
    the share of rows whose argmax is the label."""
    logits = forward_vit(params, patches, cfg=cfg, policy=policy,
                         fused=fused)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels.long()).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc}


__all__ = ["PATCH_DIM", "vit_param_shapes", "init_vit",
           "vit_params_from_numpy", "forward_vit", "vit_loss"]

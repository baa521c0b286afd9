"""Dense MLP and Mixture-of-Experts FFN on one device (port of the
reference's core/mlp.py).

Dense, GELU or SwiGLU: the pre-norm fuses into the first GEMM as a
prologue, the activation (i-GELU by default, paper T5; or the silu gate of
the fused gated GEMM) into its epilogue, and the residual add into the
second GEMM's epilogue.

MoE (Mixtral): a router GEMM (`pdot`, fp32 logits), softmax, top-k with the
reference's tie order (the lowest expert index first), then the
reference's capacity dispatch: each (token, choice) pair, token-major,
takes the next slot of its expert's buffer of `capacity` rows; pairs past
the capacity drop.  The experts' gated GEMMs run as one launch of the
gated kernel's expert form (`ops.expert_swiglu`; unfused: two batched dots
and the silu-mul), the down-projection as a batched dot, and each token
sums its choices' rows weighted by the renormalized top-k probabilities.
Every row of the input routes and takes capacity, padded or idle rows
included, as in the reference.  The reference's load-balance loss (`aux`)
belongs to training and is not computed: its serving passes drop it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.activations import get_activation
from repro_torch.core.nn import act_dtype, fused_pdot, pdot
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import Epilogue

GELU_IMPL = "i_gelu"    # the reference plan's default (sharding/plan.py)
MOE_CHUNK = 8192        # max tokens dispatched at once (bounds the buffers)


def mlp_param_shapes(cfg) -> dict:
    E, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"wg": (E, F), "wu": (E, F), "w2": (F, E)}
    if cfg.mlp_act != "gelu":
        raise NotImplementedError(f"mlp_act={cfg.mlp_act!r} is not ported")
    return {"w1": (E, F), "w2": (F, E)}


def _wcast(w, cd):
    """A weight at the compute dtype; a weight-only int8 dict as it is (the
    GEMM entry points take it, `ops.split_quantized`)."""
    return w if isinstance(w, dict) else w.to(cd)


def _first_gemm(xt, p, cfg, policy, *, norm=None):
    """xt [T, E] -> h [T, F] at the activation dtype."""
    ad = act_dtype(policy)
    cd = policy.compute_dtype
    if cfg.mlp_act == "swiglu":
        if norm is None:
            return ops.matmul_swiglu(xt.to(cd), _wcast(p["wg"], cd),
                                     _wcast(p["wu"], cd), out_dtype=ad)
        return ops.fused_matmul_swiglu(xt, p["wg"], p["wu"], prologue=norm,
                                       compute_dtype=cd, out_dtype=ad)
    if norm is None:
        h = pdot(xt, p["w1"], policy)
        return get_activation(GELU_IMPL)(h).to(ad)
    return fused_pdot(xt, p["w1"], policy, prologue=norm,
                      epilogue=Epilogue(activation=GELU_IMPL, out_dtype=ad))


def _ffn_local(xt, p, cfg, policy, *, norm=None, residual=None):
    """xt: [T, E] -> [T, E]; `residual` [T, E] folds into the second GEMM's
    epilogue (the result is then the updated stream)."""
    h = _first_gemm(xt, p, cfg, policy, norm=norm)
    if residual is not None:
        return fused_pdot(h, p["w2"], policy,
                          epilogue=Epilogue(residual=residual,
                                            out_dtype=act_dtype(policy)))
    return pdot(h, p["w2"], policy)


def mlp_full(p, x, *, cfg, policy, norm=None, residual=None):
    """x: [B, S, E] -> [B, S, E] (with `residual`: the updated stream)."""
    B, S, E = x.shape
    res = residual.reshape(B * S, E) if residual is not None else None
    y = _ffn_local(x.reshape(B * S, E), p, cfg, policy, norm=norm,
                   residual=res)
    return y.reshape(B, S, E)


def mlp_decode(p, x, *, cfg, policy, norm=None, residual=None):
    """x: [B, E] -> [B, E] (with `residual`: the updated stream)."""
    if residual is not None:
        return _ffn_local(x, p, cfg, policy, norm=norm, residual=residual)
    part = _ffn_local(x, p, cfg, policy, norm=norm)
    return part.to(torch.float32).to(act_dtype(policy))


# --------------------------------------------------------------------------
# MoE FFN
# --------------------------------------------------------------------------

def moe_param_shapes(cfg) -> dict:
    """The router and the stacked experts (drawn N(0, 0.02) by
    `blocks.init_block`, as the dense MLP's weights are)."""
    E, F, NE = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"wr": (E, NE), "wg": (NE, E, F), "wu": (NE, E, F),
            "w2": (NE, F, E)}


def _bdot(a, b, policy, *, out_dtype=None):
    """Batched expert GEMM a [NE, C, K] @ b [NE, K, N] at the compute dtype
    with fp32 accumulation, emitted at `out_dtype` (default: the
    activation dtype): the reference's dot_general, which no Pallas kernel
    runs.  On the card a bf16 product is one `torch.bmm` (cuBLAS, fp32
    accumulation); elsewhere the fp32 product of the operands."""
    cd = policy.compute_dtype
    od = out_dtype or act_dtype(policy)
    a, b = a.to(cd), b.to(cd)
    if a.device.type == "cuda" and cd == torch.bfloat16:
        return torch.bmm(a, b).to(od)
    return torch.bmm(a.float(), b.float()).to(od)


def _route(xc, wr, *, cfg, policy):
    """Router of a chunk xc [Tc, E] -> (probs [Tc, NE] fp32, top-k weights
    [Tc, K] renormalized, top-k experts [Tc, K]).  A stable descending sort
    keeps the lowest expert index first among equal probabilities, the
    order of the reference's `lax.top_k` (`torch.topk` promises none)."""
    logits = pdot(xc, wr, policy, out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.sort(probs, dim=-1, descending=True,
                       stable=True).indices[:, :cfg.top_k]
    top_w = probs.gather(1, top_i)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_i


def moe_ffn_chunk(xc, p, *, cfg, policy, capacity: int, fused: bool = True):
    """xc: [Tc, E] -> [Tc, E] at the activation dtype.

    The reference's scatter-based capacity dispatch: each (token, k) pair,
    in token-major order, takes slot = the number of earlier pairs routed
    to its expert (an exclusive running count); a slot at or past
    `capacity` drops (Switch semantics).  The expert buffers are one
    [NE * capacity + 1, E] tensor whose last row takes every dropped pair
    (the reference scatters them out of range with mode="drop") and is cut
    off; a dropped pair gathers zeros back (mode="fill").  Every shape is
    static and nothing reads the device from the host, so the decode step
    that runs this is captured in its CUDA graph."""
    Tc, E = xc.shape
    NE, K = cfg.n_experts, cfg.top_k
    ad = act_dtype(policy)
    dev = xc.device
    _, top_w, top_i = _route(xc, p["wr"], cfg=cfg, policy=policy)

    flat_e = top_i.reshape(-1)                                # [Tc * K]
    flat_w = top_w.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(NE, device=dev)[None, :]
              ).to(torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot           # exclusive
    slot = pos_in_e.gather(1, flat_e[:, None])[:, 0]
    keep = slot < capacity
    rows = torch.where(keep, flat_e * capacity + slot,
                       torch.full_like(slot, NE * capacity))
    buf = torch.zeros((NE * capacity + 1, E), dtype=ad, device=dev)
    buf[rows] = xc.repeat_interleave(K, dim=0).to(ad)
    xe = buf[:NE * capacity].view(NE, capacity, E)

    if fused:
        # the experts' gated GEMMs in one launch, silu-mul in the epilogue
        h = ops.expert_swiglu(xe, p["wg"], p["wu"],
                              compute_dtype=policy.compute_dtype,
                              out_dtype=ad)
    else:
        g = _bdot(xe, p["wg"], policy)
        u = _bdot(xe, p["wu"], policy)
        h = (torch.nn.functional.silu(g.float()) * u.float()).to(ad)
    ye = _bdot(h, p["w2"], policy).reshape(NE * capacity, E)

    y_tok = torch.where(keep[:, None], ye[torch.where(keep, rows, 0)],
                        torch.zeros((), dtype=ye.dtype, device=dev))
    y = (y_tok.float() * flat_w[:, None]).reshape(Tc, K, E).sum(1)
    return y.to(ad)


def _chunks(T: int) -> int:
    """Dispatch chunks of T tokens: the fewest equal ones of at most
    MOE_CHUNK tokens."""
    nc = max(1, math.ceil(T / MOE_CHUNK))
    while T % nc:
        nc += 1
    return nc


def moe_full(p, x, *, cfg, policy, fused: bool = True):
    """x: [B, S, E] -> [B, S, E]: the B * S tokens in `_chunks` chunks,
    each with capacity ceil(Tc * K / NE * capacity_factor)."""
    B, S, E = x.shape
    T = B * S
    nc = _chunks(T)
    Tc = T // nc
    capacity = int(math.ceil(Tc * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor))
    xs = x.reshape(nc, Tc, E)
    ys = [moe_ffn_chunk(xs[i], p, cfg=cfg, policy=policy, capacity=capacity,
                        fused=fused) for i in range(nc)]
    return torch.cat(ys).reshape(B, S, E)


def moe_decode(p, x, *, cfg, policy, fused: bool = True):
    """x: [B, E] -> [B, E]: one chunk of the B rows, capacity
    max(1, ceil(B * K / NE * capacity_factor))."""
    B = x.shape[0]
    capacity = max(1, int(math.ceil(B * cfg.top_k / cfg.n_experts
                                    * cfg.capacity_factor)))
    return moe_ffn_chunk(x, p, cfg=cfg, policy=policy, capacity=capacity,
                         fused=fused)

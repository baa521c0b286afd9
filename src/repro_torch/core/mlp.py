"""Dense MLP on one device (port of the reference's core/mlp.py dense path),
GELU or SwiGLU: the pre-norm fuses into the first GEMM as a prologue, the
activation (i-GELU by default, paper T5; or the silu gate of the fused
gated GEMM) into its epilogue, and the residual add into the second GEMM's
epilogue."""
from __future__ import annotations

import torch

from repro_torch.core.activations import get_activation
from repro_torch.core.nn import act_dtype, fused_pdot, pdot
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import Epilogue

GELU_IMPL = "i_gelu"    # the reference plan's default (sharding/plan.py)


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

"""Mamba2 SSD block on one device (port of the reference's core/ssm.py,
single-device route).

Projections x -> (x_ssm, z, B|C, dt) are plain products (`pdot`), as the
reference leaves them to XLA; the depthwise causal convolutions and the
gated RMSNorm are plain PyTorch, as the reference runs them in jnp; the
chunked scan is `ops.ssd` (the hand-written kernel on the card) and the
one-step decode update `ops.ssd_decode`.

Head padding: heads are padded to a multiple of TP_PAD (hymba: 50 -> 64),
so the parameter shapes equal the reference's.  The pad heads'
out-projection rows are zero and the gated-RMSNorm statistics run over the
real d_inner only, so the output is exact.

Caches per layer: "h" [B, Hp, P, N] fp32 state; "cx" / "cbc" the last
cw - 1 PRE-conv inputs of the x and B|C streams [B, cw - 1, ·] in the
activation dtype.  The reference's sequence-parallel variant
(`_ssm_full_seqp`, `_shard_state_scan`) is multi-device and not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.nn import act_dtype, pdot
from repro_torch.kernels import ops
from repro_torch.kernels.epilogue import RMS_EPS

TP_PAD = 16     # heads padded to multiples of this (the reference's tp axis)


def _dims(cfg):
    Hp = cfg.padded_ssm_heads(TP_PAD)
    P = cfg.ssm_head_dim
    return Hp, P, Hp * P, cfg.ssm_state, cfg.conv_width


def ssm_param_shapes(cfg) -> dict:
    E = cfg.d_model
    Hp, P, dip, N, cw = _dims(cfg)
    return {
        "w_x": (E, dip), "w_z": (E, dip), "w_bc": (E, 2 * N),
        "w_dt": (E, Hp), "dt_bias": (Hp,), "a_log": (Hp,), "d_skip": (Hp,),
        "conv_x": (cw, dip), "conv_bc": (cw, 2 * N),
        "norm_scale": (dip,), "w_out": (dip, E),
    }


def init_ssm(generator, cfg, dtype, device) -> dict:
    """One layer's weights drawn as the reference draws them (its own
    numbers differ: `torch.Generator` is not `jax.random`): N(0, 0.02)
    projections with zero pad-head rows in w_out, dt in [1e-3, 0.1] through
    an inverse-softplus bias, A = -U(1, 16), unit skip, N(0, 0.1) x conv and
    an identity B|C conv."""
    E = cfg.d_model
    Hp, P, dip, N, cw = _dims(cfg)
    real_dip = cfg.ssm_heads * P

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device) * std

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    w_out = normal((dip, E), 0.02)
    w_out[real_dip:] = 0.0                # pad heads: output exact
    dt = torch.exp(uniform((Hp,), math.log(1e-3), math.log(0.1)))
    conv_bc = torch.zeros((cw, 2 * N), device=device)
    conv_bc[-1] = 1.0
    out = {
        "w_x": normal((E, dip), 0.02), "w_z": normal((E, dip), 0.02),
        "w_bc": normal((E, 2 * N), 0.02), "w_dt": normal((E, Hp), 0.02),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(uniform((Hp,), 1.0, 16.0)),
        "d_skip": torch.ones((Hp,), device=device),
        "conv_x": normal((cw, dip), 0.1), "conv_bc": conv_bc,
        "norm_scale": torch.ones((dip,), device=device), "w_out": w_out,
    }
    return {k: v.to(dtype) for k, v in out.items()}


def _causal_conv(x, w):
    """Depthwise causal conv + silu.  x: [B, S, D]; w: [cw, D]."""
    cw = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    wf = w.float()
    y = sum(xp[:, j:j + S].float() * wf[j] for j in range(cw))
    return F.silu(y).to(x.dtype)


def _conv_step(x_t, state, w):
    """x_t: [B, D]; state: [B, cw-1, D] (previous inputs).  Returns
    (y_t [B, D], new_state)."""
    window = torch.cat([state, x_t[:, None]], dim=1)            # [B, cw, D]
    y = torch.einsum("bcd,cd->bd", window.float(), w.float())
    return F.silu(y).to(x_t.dtype), window[:, 1:]


def _conv_tail(raw, cw):
    """The last cw - 1 pre-conv inputs [B, cw-1, D]; a prompt shorter than
    that is left-padded with the zeros the causal conv saw."""
    return F.pad(raw, (0, 0, cw - 1, 0))[:, -(cw - 1):]


def _masked_rmsnorm(y, z, scale, real_dip: int, *, eps=RMS_EPS):
    """Gated RMSNorm over the (possibly padded) d_inner dim:
    y <- rmsnorm(y * silu(z)) * scale with statistics over the real dims
    only."""
    real = torch.arange(y.shape[-1], device=y.device) < real_dip
    g = y.float() * F.silu(z.float())
    g = torch.where(real, g, torch.zeros((), device=y.device))
    var = (g * g).sum(-1, keepdim=True) / real_dip
    out = g * torch.rsqrt(var + eps) * scale.float()
    return out.to(y.dtype)


def ssm_full(p, x, *, cfg, policy, with_cache: bool = False):
    """x: [B, S, E] -> (y [B, S, E], cache | None), cache = {"h", "cx",
    "cbc"}."""
    Hp, P, dip, N, cw = _dims(cfg)
    ad = act_dtype(policy)
    B, S, _ = x.shape

    xs_raw = pdot(x, p["w_x"], policy)                          # [B, S, dip]
    z = pdot(x, p["w_z"], policy)
    bc_raw = pdot(x, p["w_bc"], policy)                         # [B, S, 2N]
    dt_raw = pdot(x, p["w_dt"], policy, out_dtype=torch.float32)

    xs = _causal_conv(xs_raw, p["conv_x"])
    bc = _causal_conv(bc_raw, p["conv_bc"])
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())                          # [Hp]

    y, h = ops.ssd(xs.reshape(B, S, Hp, P).to(ad), dt, A, Bm.to(ad),
                   Cm.to(ad), p["d_skip"].float())
    y = y.reshape(B, S, dip)
    y = _masked_rmsnorm(y, z, p["norm_scale"], cfg.ssm_heads * P)
    out = pdot(y, p["w_out"], policy)

    cache = None
    if with_cache:
        cache = {"h": h.float(), "cx": _conv_tail(xs_raw, cw).to(ad),
                 "cbc": _conv_tail(bc_raw, cw).to(ad)}
    return out, cache


def ssm_decode(p, x, cache, *, cfg, policy):
    """One decode step.  x: [B, E]; cache: {"h", "cx", "cbc"}.  Returns
    (y [B, E], new cache) — new tensors; the caller stores them."""
    Hp, P, dip, N, cw = _dims(cfg)
    ad = act_dtype(policy)
    B = x.shape[0]

    xs = pdot(x, p["w_x"], policy)                              # [B, dip]
    z = pdot(x, p["w_z"], policy)
    bc = pdot(x, p["w_bc"], policy)
    dt_raw = pdot(x, p["w_dt"], policy, out_dtype=torch.float32)

    xs, cx = _conv_step(xs, cache["cx"], p["conv_x"])
    bc, cbc = _conv_step(bc, cache["cbc"], p["conv_bc"])
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())

    y, h = ops.ssd_decode(xs.reshape(B, Hp, P).float(), dt, A, Bm.float(),
                          Cm.float(), p["d_skip"].float(), cache["h"])
    y = y.reshape(B, dip).to(ad)
    y = _masked_rmsnorm(y, z, p["norm_scale"], cfg.ssm_heads * P)
    out = pdot(y, p["w_out"], policy, out_dtype=torch.float32).to(ad)
    return out, {"h": h, "cx": cx, "cbc": cbc}

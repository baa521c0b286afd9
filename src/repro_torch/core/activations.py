"""Activation functions, including the paper's i-GELU polynomial (T5).

`i_gelu` is the I-BERT second-order polynomial approximation of GELU (Kim et
al.), the serving default; it is not `torch.nn.functional.gelu`.  Each
function computes in fp32 and returns the input's dtype, as the reference's
core/activations.py does.
"""
from __future__ import annotations

import math

import torch

# I-BERT constants: L(x) = sign(x) [a (clip(|x|, max=-b) + b)^2 + 1]
_A = -0.2888
_B = -1.769


def i_gelu(x):
    """Second-order polynomial GELU (I-BERT).  Max abs err ~0.01."""
    xf = x.float()
    arg = xf * (1.0 / math.sqrt(2.0))
    sgn = torch.sign(arg)
    a = torch.clamp(arg.abs(), max=-_B)
    erf_approx = sgn * (_A * (a + _B) ** 2 + 1.0)
    return (0.5 * xf * (1.0 + erf_approx)).to(x.dtype)


def gelu_exact(x):
    return torch.nn.functional.gelu(x.float(), approximate="none").to(x.dtype)


def gelu_tanh(x):
    return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu(x):
    return torch.nn.functional.silu(x.float()).to(x.dtype)


ACTIVATIONS = {
    "gelu": gelu_tanh,
    "gelu_exact": gelu_exact,
    "i_gelu": i_gelu,
    "silu": silu,
}


def get_activation(name: str):
    return ACTIVATIONS[name]


def activation_grad(name: str, z):
    """d act(z) / dz in fp32 at the fp32 pre-activation `z`: the
    derivative JAX's autodiff takes of the reference's activations.  For
    i-GELU that is its conventions at the kinks: `sign` contributes 0, and
    the clip min(|arg|, 1.769) contributes 1 below the clip, 1/2 at it
    (`lax.min`'s tie rule) and 0 beyond it."""
    z = z.float()
    if name == "i_gelu":
        inv = 1.0 / math.sqrt(2.0)
        arg = z * inv
        sgn = torch.sign(arg)
        mag = arg.abs()
        a = torch.clamp(mag, max=-_B)
        erf_approx = sgn * (_A * (a + _B) ** 2 + 1.0)
        dmin = torch.where(mag < -_B, 1.0, torch.where(mag == -_B, 0.5, 0.0))
        derf = sgn * sgn * (2.0 * _A) * (a + _B) * dmin * inv
        return 0.5 * (1.0 + erf_approx) + 0.5 * z * derf
    if name == "gelu_exact":
        cdf = 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))
        return cdf + z * torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2 * math.pi))
    if name == "gelu":
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (z + 0.044715 * z ** 3))
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * c * (
            1.0 + 3 * 0.044715 * z * z)
    if name == "silu":
        s = torch.sigmoid(z)
        return s * (1.0 + z * (1.0 - s))
    raise ValueError(f"no derivative for activation {name!r}")

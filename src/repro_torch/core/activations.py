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

"""Mamba2 SSD chunked scan (prefill).

Replaces the TPU kernels `src/repro/kernels/ssd.py:ssd_multihead`
(`_ssd_mh_kernel`) and `:ssd` (`_ssd_kernel`): one function, which the TPU
splits in two by a VMEM rule (`src/repro/kernels/ops.py:ssd`).  One CUDA
source, `csrc/ssd.cu`, serves both; its note says what bounds it on an
H100 and how the design answers it.

`ssd_plain` is the kernel's arithmetic in plain PyTorch: the chunked
state-space-duality form at the kernel's chunk length (`CHUNK`), with the
sequence right-padded to a whole chunk by dt = 0, x = B = C = 0.  That
padding is exact: a pad step decays the state by exp(0) = 1 and adds
nothing to it, so y[:S] and h_final are those of the unpadded sequence —
the kernel takes any S, where the reference's Pallas kernels need the
chunk to divide S.  `ssd` launches the kernel for CUDA tensors and takes
the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunked_ref

CHUNK = 64                 # csrc/ssd.cu SSD_L
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 7 + [_P]


def ssd_plain(x, dt, A, B, C, D):
    """x: [Bt, S, H, P], dt: [Bt, S, H], A / D: [H], B / C: [Bt, S, N]
    -> (y [Bt, S, H, P] in x's dtype, h_final [Bt, H, P, N] fp32)."""
    S = x.shape[1]
    pad = -S % CHUNK
    if pad:
        x, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                           + (0, pad)) for t in (x, B, C))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    y, h = ssd_chunked_ref(x, dt, A, B, C, D, chunk=CHUNK)
    return y[:, :S], h


def ssd(x, dt, A, B, C, D):
    """The chunked SSD scan -> (y, h_final); shapes as `ssd_plain`."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, D)
    build.require_cuda("ssd", x, dt, A, B, C, D)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if (S == 0 or dt.shape != (Bt, S, H) or B.shape != (Bt, S, N)
            or C.shape != B.shape or A.shape != (H,) or D.shape != (H,)
            or B.dtype != C.dtype):
        raise ValueError(f"ssd: unsupported operands x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    h = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.bind("ssd", "repro_ssd", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S,
             H, P, N, build.dtype_code(x), build.dtype_code(B),
             build.stream_of(x))
    build.check(err, f"ssd launch (state width N = {N}: a block holds its "
                     f"[P-tile, N] state and a chunk of B / C in shared "
                     f"memory)")
    ssd.launches += 1
    return y, h


ssd.launches = 0

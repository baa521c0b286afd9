"""Mamba2 SSD chunked scan (prefill).

Replaces the TPU kernels `src/repro/kernels/ssd.py:ssd_multihead`
(`_ssd_mh_kernel`) and `:ssd` (`_ssd_kernel`): one function, which the TPU
splits in two by a VMEM rule (`src/repro/kernels/ops.py:ssd`).  One CUDA
source, `csrc/ssd.cu`, serves both with three kernels a call: the chunks'
own states (and C.B^T once per chunk), the scan over chunks, the chunks'
outputs.  Its note says what bounds it on an H100 and how the design
answers it.

`ssd_plain` is the kernels' arithmetic in plain PyTorch, stage by stage, in
fp32: the sequence right-padded to a whole chunk (`CHUNK`) by dt = 0,
x = B = C = 0, G = C.B^T, each chunk's own state and decay, the scan that
gives the state entering each chunk, then the outputs.  That padding is
exact: a pad step decays the state by exp(0) = 1 and adds nothing to it,
so y[:S] and h_final are those of the unpadded sequence — the kernel takes
any S, where the reference's Pallas kernels need the chunk to divide S.
`ssd_emulate` is the same with the kernels' tensor-core operands: every
fp32 operand of a product split into bf16 hi + lo, the lo x lo term
dropped.  `ssd` launches the kernels for CUDA tensors and takes the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK = 64                        # csrc/ssd.cu SSD_L
HEAD_DIM = 64                     # csrc/ssd.cu SSD_P
STATE_WIDTHS = (16, 32, 64, 128)  # the widths N csrc/ssd.cu is compiled for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 7 + [_P]


def _hi_lo(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _dot(eq, a, b, split_a, split_b):
    """einsum(eq, a, b) in fp32; a `split` operand enters as its bf16 hi and
    lo parts, as the kernels' tensor-core products take it: hi.hi + lo.hi
    + hi.lo."""
    if not (split_a or split_b):
        return torch.einsum(eq, a, b)
    ah, al = _hi_lo(a) if split_a else (a, None)
    bh, bl = _hi_lo(b) if split_b else (b, None)
    out = torch.einsum(eq, ah, bh)
    if al is not None:
        out = out + torch.einsum(eq, al, bh)
    if bl is not None:
        out = out + torch.einsum(eq, ah, bl)
    return out


def _chunks(x, dt, B, C):
    """x, dt, B, C in fp32, right-padded to whole chunks and cut into them:
    [Bt, nc, L, H, P], [Bt, nc, L, H], [Bt, nc, L, N] twice."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S
    F = torch.nn.functional
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf, Bf, Cf = (F.pad(t.float(), (0, 0, 0, pad)) for t in (dt, B, C))
    return (xf.reshape(Bt, nc, CHUNK, H, P), dtf.reshape(Bt, nc, CHUNK, H),
            Bf.reshape(Bt, nc, CHUNK, N), Cf.reshape(Bt, nc, CHUNK, N))


def ssd_stages(x, dt, A, B, C, *, split=False):
    """The kernels' first two stages -> (G [Bt, nc, L, L], cum [Bt, nc, L,
    H], each chunk's own state [Bt, nc, H, P, N], the state entering each
    chunk (same shape), h_final [Bt, H, P, N]), all fp32, over the padded
    sequence.  `split`: products as `ssd_emulate` takes them."""
    Bt, _, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = _chunks(x, dt, B, C)
    sx = split and x.dtype != torch.bfloat16   # x, B, C split when fp32

    # ssd_state_kernel: G once per chunk; cum; x * w; the chunk's state
    G = _dot("bctn,bcsn->bcts", Cf, Bf, sx, sx)
    cum = torch.cumsum(dtf * A.float(), dim=2)
    last = cum[:, :, -1:]
    w = torch.exp(last - cum) * dtf
    own = _dot("bcshp,bcsn->bchpn", xf * w[..., None], Bf, split, sx)
    decay = torch.exp(last[:, :, 0])                       # [Bt, nc, H]

    # ssd_scan_kernel: h entering chunk c, then h_final
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(xf.shape[1]):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + own[:, c]
    return G, cum, own, torch.stack(h_in, 1), h


def _ssd(x, dt, A, B, C, D, *, split):
    Bt, S, H, P = x.shape
    G, cum, _, h_in, h = ssd_stages(x, dt, A, B, C, split=split)
    xf, dtf, _, Cf = _chunks(x, dt, B, C)
    nc, L = xf.shape[1], CHUNK
    sx = split and x.dtype != torch.bfloat16

    # ssd_out_kernel: M = G exp(cum_t - cum_s) dt_s (s <= t), then
    # M . x + exp(cum_t) C_t . h_c + D x
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [Bt,nc,t,s,H]
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    M = torch.where(tri[None, None, :, :, None],
                    G[..., None] * torch.exp(seg) * dtf[:, :, None],
                    torch.zeros((), device=x.device))
    y = _dot("bctsh,bcshp->bcthp", M, xf, split, sx)
    y = y + torch.exp(cum)[..., None] * _dot("bctn,bchpn->bcthp", Cf, h_in,
                                             sx, split)
    y = y + D.float()[:, None] * xf
    return y.reshape(Bt, nc * L, H, P)[:, :S].to(x.dtype), h


def ssd_plain(x, dt, A, B, C, D):
    """x: [Bt, S, H, P], dt: [Bt, S, H], A / D: [H], B / C: [Bt, S, N]
    -> (y [Bt, S, H, P] in x's dtype, h_final [Bt, H, P, N] fp32)."""
    return _ssd(x, dt, A, B, C, D, split=False)


def ssd_emulate(x, dt, A, B, C, D):
    """`ssd_plain` with the kernels' tensor-core operands: each fp32 operand
    of a product (x * w, the decay-weighted G, the state entering a chunk;
    x, B and C themselves when they are fp32) split into bf16 hi + lo."""
    return _ssd(x, dt, A, B, C, D, split=True)


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
    if P != HEAD_DIM or N not in STATE_WIDTHS or x.dtype != B.dtype:
        raise ValueError(f"ssd: the kernels take head dim {HEAD_DIM}, state "
                         f"width N in {STATE_WIDTHS} and x, B, C of one "
                         f"dtype; got P = {P}, N = {N}, x {x.dtype}, B / C "
                         f"{B.dtype}")
    x, B, C = (t.contiguous() for t in (x, B, C))
    x, B, C = (t if build.aligned16(t) else t.clone() for t in (x, B, C))
    dt, A, D = (t.float().contiguous() for t in (dt, A, D))
    nc = -(-S // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((Bt, H, P, N), **f32)
    states = torch.empty((Bt, nc, H, P, N), **f32)
    decay = torch.empty((Bt, nc, H), **f32)
    gmat = torch.empty((Bt, nc, CHUNK, CHUNK), **f32)
    fn = build.bind("ssd", "repro_ssd", _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
             states.data_ptr(), decay.data_ptr(), gmat.data_ptr(), Bt, S, H,
             P, N, build.dtype_code(x), build.dtype_code(B),
             build.stream_of(x))
    build.check(err, "ssd launch")
    ssd.launches += 1
    return y, h


ssd.launches = 0

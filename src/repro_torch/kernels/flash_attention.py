"""FlashAttention-2 forward (prefill).

Replaces the TPU kernel `src/repro/kernels/flash_attention.py:
flash_attention` (`_fa_kernel`).  The CUDA source is
`csrc/flash_attention.cu`; its note says what bounds the kernel on an H100
and how the design answers it.

`flash_attention_plain` is the kernel's arithmetic in plain PyTorch: fp32
scores (the operands' exact products summed in fp32) times 1/sqrt(D),
-1e30 masks, online softmax over KV tiles with fp32 (m, l, acc), P cast to
V's dtype for P.V, output acc / max(l, 1e-30).  It differs from
`ref.flash_attention_ref` (scores rounded to the operand dtype) by rounding
only.  `flash_attention` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 12 + [ctypes.c_float, _P]


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                          block_kv=32):
    """q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] -> [B, Sq, H, D]."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    dev = q.device
    sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KV, G, D)
    qpos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=dev)
    for t0 in range(0, Skv, block_kv):
        kb = k[:, t0:t0 + block_kv].float()
        vb = v[:, t0:t0 + block_kv].float()
        kpos = torch.arange(t0, t0 + kb.shape[1], device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb) * sm_scale
        ok = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok &= kpos[None, :] <= qpos[:, None]
        if window and window > 0:
            ok &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(ok[None, None, None], s,
                        torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """q: [B, Sq, H, D]; k, v: [B, Skv, KV, D] -> [B, Sq, H, D] at q's dtype.
    `q_offset` is the static absolute position of query row 0."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    build.require_cuda("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if (Dk != D or v.shape != k.shape or H % KV or D % 4 or D > 256
            or q.dtype != k.dtype or k.dtype != v.dtype):
        raise ValueError(f"flash_attention: unsupported operands q "
                         f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = build.bind("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, Sq, Skv, H, KV, D, int(q_offset), int(bool(causal)),
             int(window or 0), Skv, build.dtype_code(q),
             int(build.aligned16(q, k, v)), 1.0 / math.sqrt(D),
             build.stream_of(q))
    build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

"""FlashAttention-2 forward (prefill).

Replaces the TPU kernel `src/repro/kernels/flash_attention.py:
flash_attention` (`_fa_kernel`).  The CUDA source is
`csrc/flash_attention.cu`, two templates that `flash_plan` picks per call:

  ``wgmma``  bf16 with D a multiple of 16 up to 256: TMA and tensor cores,
             64 query rows a block, KV tiles of 64 keys (`FW_TILE`);
  ``simt``   fp32, and bf16 at any other D: the first design, FMA on CUDA
             cores, 16 query rows a block, KV tiles of 32 keys.

The source's note says what bounds the kernel on an H100 and how each
design answers it.

`flash_attention_plain` is the kernel's arithmetic in plain PyTorch: fp32
scores (the operands' exact products summed in fp32) times 1/sqrt(D),
-1e30 masks, online softmax over KV tiles with fp32 (m, l, acc), P cast to
V's dtype for P.V, output acc / max(l, 1e-30).  It differs from
`ref.flash_attention_ref` (scores rounded to the operand dtype) by rounding
only.  `flash_emulate` repeats the wgmma template's arithmetic (its tile
order and skipped tiles) for the tests.  `flash_attention` launches the
kernel for CUDA tensors and takes the plain version for CPU tensors; it
raises on operands no template takes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 12 + [ctypes.c_float, _P]
_WGMMA_ARGTYPES = [_P] * 4 + [_I] * 10 + [ctypes.c_float, _P]
TEMPLATES = ("wgmma", "simt")
FW_TILE = 64            # csrc/flash_attention.cu FW_BQ = FW_BKV


def flash_plan(dtype, D: int) -> str:
    """The template of a call with operands of `dtype` and head dim `D`:
    wgmma for bf16 at D a multiple of 16 up to 256, else simt (fp32, or
    bf16 at another D up to 256, a multiple of 4).  Raises on the rest."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{dtype}")
    if dtype == torch.bfloat16 and D % 16 == 0 and 16 <= D <= 256:
        return "wgmma"
    if D % 4 or not 4 <= D <= 256:
        raise ValueError(f"flash_attention: no template takes head dim {D}")
    return "simt"


def flash_tiles(Sq, Skv, *, causal, window, q_offset, tile=FW_TILE):
    """For each query tile [q0, q0 + tile) the KV tiles [j0, j1) of `tile`
    keys that some row of it attends (the kernel's exact skips)."""
    out = []
    for q0 in range(0, Sq, tile):
        qfirst = q0 + q_offset
        qlast = min(q0 + tile, Sq) - 1 + q_offset
        j1 = -(-Skv // tile)
        if causal:
            j1 = min(j1, qlast // tile + 1)
        lo = qfirst - window + 1
        j0 = lo // tile if window and window > 0 and lo > 0 else 0
        out.append((q0, j0, j1))
    return out


def flash_emulate(q, k, v, *, causal=True, window=0, q_offset=0,
                  tile=FW_TILE):
    """The wgmma template's arithmetic in plain PyTorch (tests only): per
    `tile`-row query tile, only the KV tiles of `flash_tiles`, in order;
    fp32 scores of the operands times 1/sqrt(D), -1e30 masks, the online
    softmax in fp32, P rounded to V's dtype, fp32 accumulation."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    sm_scale = 1.0 / math.sqrt(D)
    out = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32)
    qf = q.float().reshape(B, Sq, KV, G, D)
    for q0, j0, j1 in flash_tiles(Sq, Skv, causal=causal, window=window,
                                  q_offset=q_offset, tile=tile):
        qt = qf[:, q0:q0 + tile]
        nq = qt.shape[1]
        qpos = torch.arange(q0, q0 + nq) + q_offset
        m = torch.full((B, KV, G, nq), NEG_INF)
        l = torch.zeros((B, KV, G, nq))
        acc = torch.zeros((B, KV, G, nq, D))
        for j in range(j0, j1):
            kb = k[:, j * tile:(j + 1) * tile].float()
            vb = v[:, j * tile:(j + 1) * tile]
            kpos = torch.arange(j * tile, j * tile + kb.shape[1])
            s = torch.einsum("bqkgd,bskd->bkgqs", qt, kb) * sm_scale
            ok = torch.ones((nq, kb.shape[1]), dtype=torch.bool)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window and window > 0:
                ok &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(ok, s, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        out[..., q0:q0 + nq, :] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


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
    if (Dk != D or v.shape != k.shape or H % KV or k.shape[0] != B
            or q.dtype != k.dtype or k.dtype != v.dtype):
        raise ValueError(f"flash_attention: unsupported operands q "
                         f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype}")
    template = flash_plan(q.dtype, D)
    out = _run(template, q, k, v, causal=causal, window=window,
               q_offset=q_offset)
    flash_attention.launches += 1
    flash_attention.launches_by[template] += 1
    return out


def _run(template, q, k, v, *, causal, window, q_offset):
    """Launch one template on checked CUDA operands (`flash_attention`
    plans it; `chip_smoke.py` also times the simt template on bf16 as the
    first design's yardstick)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, D, int(q_offset), int(bool(causal)),
            int(window or 0), Skv)
    if template == "wgmma":
        if not build.aligned16(q, k, v, out):
            raise ValueError("flash_attention: the wgmma template's tensor "
                             "maps need 16-byte aligned operands")
        fn = build.bind("flash_attention", "repro_flash_attention_wgmma",
                        _WGMMA_ARGTYPES)
        err = fn(*args, 1.0 / math.sqrt(D), build.stream_of(q))
    else:
        fn = build.bind("flash_attention", "repro_flash_attention",
                        _ARGTYPES)
        err = fn(*args, build.dtype_code(q), int(build.aligned16(q, k, v)),
                 1.0 / math.sqrt(D), build.stream_of(q))
    build.check(err, f"flash_attention launch ({template})")
    return out


flash_attention.launches = 0
flash_attention.launches_by = dict.fromkeys(TEMPLATES, 0)

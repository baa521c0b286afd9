"""Plain PyTorch oracles: a line-for-line port of the reference's
kernels/ref.py for the kernels on the port's main path.

Each `*_ref` follows the paper's precision rules with the reference's own
casts (fp32 softmax/statistics, fp32 GEMM accumulation, operand-dtype dot
outputs where the reference emits them), so on the CPU the port's `ref` mode
reproduces the JAX reference path.  Written for clarity, not speed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.epilogue import LN_EPS, RMS_EPS

NEG_INF = -1e30


def _dot(a, b, out_dtype=torch.float32):
    """a [..., K] @ b [K, N] with fp32 accumulation, emitted as `out_dtype`
    (the reference's dot_general with preferred_element_type)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_ref(a, b, *, activation: str = "none", out_dtype=None):
    """C = act(A @ B); the dot emits `out_dtype`, the activation runs in
    fp32."""
    out_dtype = out_dtype or a.dtype
    if activation == "none":
        return _dot(a, b, out_dtype)
    c = _dot(a, b, out_dtype).float()
    if activation == "gelu":
        c = torch.nn.functional.gelu(c, approximate="tanh")
    elif activation == "silu":
        c = torch.nn.functional.silu(c)
    else:
        raise ValueError(activation)
    return c.to(out_dtype)


def _attn_mask(q_len, kv_len, *, causal, window, q_offset=0, device=None):
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window and window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  out_dtype=None):
    """Naive full-materialization attention.  q: [B, Sq, H, D]; k, v:
    [B, Skv, KV, D] (H % KV == 0).  Softmax in fp32."""
    out_dtype = out_dtype or q.dtype
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    mask = _attn_mask(Sq, Skv, causal=causal, window=window,
                      q_offset=q_offset, device=q.device)
    scores = torch.where(mask[None, None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(out_dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                        block_kv=128, out_dtype=None):
    """Online-softmax (FlashAttention-2 dataflow) oracle over KV blocks with
    running fp32 (m, l, o).  Scores are emitted in the operand dtype and
    upcast; P is cast to the operand dtype for the P.V product."""
    out_dtype = out_dtype or q.dtype
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, Sq, KV, G, D)
    qpos = torch.arange(Sq, device=dev) + q_offset

    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32, device=dev)
    for s0 in range(0, Skv, block_kv):
        kb = k[:, s0:s0 + block_kv]
        vb = v[:, s0:s0 + block_kv]
        pos_b = torch.arange(s0, s0 + kb.shape[1], device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", qr.float(), kb.float()
                         ).to(q.dtype).float() * scale
        msk = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            msk &= pos_b[None, :] <= qpos[:, None]
        if window and window > 0:
            msk &= pos_b[None, :] > qpos[:, None] - window
        s = torch.where(msk[None, None, None], s,
                        torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(out_dtype)


def _paged_gather(k_pool, v_pool, block_tables, lengths):
    """Dereference block tables into a dense [B, MB*BS, KV, D] fp32 view
    plus a [B, MB*BS] validity mask (token t of entry e holds absolute
    position e*BS + t; entries < 0 are absent)."""
    _, BS, KV, D = k_pool.shape
    B, MB = block_tables.shape
    present = block_tables >= 0
    tab = torch.where(present, block_tables, torch.zeros_like(block_tables))
    tab = tab.long()
    k = k_pool.float()[tab].reshape(B, MB * BS, KV, D)
    v = v_pool.float()[tab].reshape(B, MB * BS, KV, D)
    pos = torch.arange(MB * BS, device=k_pool.device)[None, :]
    msk = pos < lengths.to(torch.int32)[:, None]
    msk &= torch.repeat_interleave(present, BS, dim=1)
    return k, v, msk


def _paged_scores(q, k, msk):
    """Masked fp32 scores [B, KV, G, S] from q [B, H, D]."""
    B, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k)
    return torch.where(msk[:, None, None], s,
                       torch.tensor(NEG_INF, device=q.device))


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               out_dtype=None):
    """Paged single-token decode oracle: gathers the table into a dense
    cache and defers to the dense softmax.  -> [B, H, D]."""
    out_dtype = out_dtype or q.dtype
    B, H, D = q.shape
    k, v, msk = _paged_gather(k_pool, v_pool, block_tables, lengths)
    s = _paged_scores(q, k, msk)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, H, D).to(out_dtype)


def paged_decode_partials_ref(q, k_pool, v_pool, block_tables, lengths):
    """Paged decode oracle emitting unnormalized online-softmax partials
    -> (o [B, H, D] fp32, m [B, H], l [B, H])."""
    B, H, D = q.shape
    k, v, msk = _paged_gather(k_pool, v_pool, block_tables, lengths)
    s = _paged_scores(q, k, msk)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def rmsnorm_ref(x, gamma, *, eps=RMS_EPS, out_dtype=None):
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * gamma.float()
    return y.to(out_dtype)


def layernorm_ref(x, gamma, beta, *, eps=LN_EPS, out_dtype=None):
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(out_dtype)


def norm_prologue_ref(x, *, norm, gamma, nbeta=None, eps):
    """Normalize the GEMM `a` operand (output in x.dtype, like ops.norm)."""
    if norm == "rmsnorm":
        return rmsnorm_ref(x, gamma, eps=eps)
    if norm == "layernorm":
        return layernorm_ref(x, gamma, nbeta, eps=eps)
    if norm != "none":
        raise ValueError(norm)
    return x


def fused_matmul_ref(x, w, *, norm="none", gamma=None, nbeta=None,
                     w_scale=None, bias=None, residual=None,
                     activation="none", eps=RMS_EPS, compute_dtype=None,
                     dot_dtype=None, out_dtype=None):
    """act(norm(x) @ w + bias) cast to out_dtype, + residual — the exact op
    chain of the unfused path (normalize, cast to the compute dtype, dot
    emitting `dot_dtype`, bias, activation, cast, residual add)."""
    from repro_torch.core.activations import get_activation
    h = norm_prologue_ref(x, norm=norm, gamma=gamma, nbeta=nbeta, eps=eps)
    cd = compute_dtype or h.dtype
    od = dot_dtype or out_dtype or h.dtype
    y = _dot(h.to(cd), w.to(cd), od)
    if w_scale is not None:
        y = (y.float() * w_scale.float()).to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if activation != "none":
        y = get_activation(activation)(y)
    if out_dtype is not None:
        y = y.to(out_dtype)
    if residual is not None:
        y = residual + y
    return y


def fused_matmul_swiglu_ref(x, w_gate, w_up, *, norm="none", gamma=None,
                            nbeta=None, residual=None, eps=RMS_EPS,
                            compute_dtype=None, out_dtype=None):
    """silu(norm(x) @ wg) * (norm(x) @ wu) [+ residual] — the exact op
    chain of the unfused gated MLP (normalize, cast to the compute dtype,
    two dots emitting `out_dtype`, fp32 silu-mul, cast, residual add)."""
    h = norm_prologue_ref(x, norm=norm, gamma=gamma, nbeta=nbeta, eps=eps)
    cd = compute_dtype or h.dtype
    od = out_dtype or h.dtype
    a = h.to(cd)
    g = matmul_ref(a, w_gate.to(cd), activation="none", out_dtype=od)
    u = matmul_ref(a, w_up.to(cd), activation="none", out_dtype=od)
    y = (torch.nn.functional.silu(g.float()) * u.float()).to(od)
    if residual is not None:
        y = residual + y
    return y

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


def decode_attention_ref(q, k_cache, v_cache, length, *, window=0,
                         out_dtype=None):
    """Single-token decode oracle.  q: [B, H, D]; caches: [B, S, KV, D];
    `length`: number of valid cache entries (scalar or [B]).  Entries at
    positions >= length are masked.  `window`: only the last `window`
    positions attend (SWA)."""
    out_dtype = out_dtype or q.dtype
    B, S, KV, D = k_cache.shape
    H = q.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, KV, G, D)
    kf = k_cache.float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, kf)
    pos = torch.arange(S, device=q.device)[None, :]
    length = torch.as_tensor(length, device=q.device)
    ln = length[:, None] if length.ndim else length.reshape(1, 1)
    msk = pos < ln
    if window and window > 0:
        msk = msk & (pos >= ln - window)
    s = torch.where(msk[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, D).to(out_dtype)


def _paged_gather(k_pool, v_pool, block_tables, lengths, k_scale=None,
                  v_scale=None):
    """Dereference block tables into a dense [B, MB*BS, KV, D] fp32 view
    plus a [B, MB*BS] validity mask (token t of entry e holds absolute
    position e*BS + t; entries < 0 are absent).  `k_scale` / `v_scale`
    ([NB, KV] fp32): the per-block-per-head scales of int8 pools, applied
    here (absent entries read block 0's).  Only the table's blocks are
    widened: widening the pool first would copy every block of it."""
    _, BS, KV, D = k_pool.shape
    B, MB = block_tables.shape
    present = block_tables >= 0
    tab = torch.where(present, block_tables, torch.zeros_like(block_tables))
    tab = tab.long()
    k = k_pool[tab].float()                          # [B, MB, BS, KV, D]
    v = v_pool[tab].float()
    if k_scale is not None:
        k = k * k_scale[tab].float()[:, :, None, :, None]
    if v_scale is not None:
        v = v * v_scale[tab].float()[:, :, None, :, None]
    k = k.reshape(B, MB * BS, KV, D)
    v = v.reshape(B, MB * BS, KV, D)
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
                               k_scale=None, v_scale=None, out_dtype=None):
    """Paged single-token decode oracle: gathers the table into a dense
    cache and defers to the dense softmax.  `k_scale` / `v_scale`: the
    scales of int8 pools.  -> [B, H, D]."""
    out_dtype = out_dtype or q.dtype
    B, H, D = q.shape
    k, v, msk = _paged_gather(k_pool, v_pool, block_tables, lengths,
                              k_scale, v_scale)
    s = _paged_scores(q, k, msk)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(B, H, D).to(out_dtype)


def paged_decode_partials_ref(q, k_pool, v_pool, block_tables, lengths, *,
                              k_scale=None, v_scale=None):
    """Paged decode oracle emitting unnormalized online-softmax partials
    -> (o [B, H, D] fp32, m [B, H], l [B, H])."""
    B, H, D = q.shape
    k, v, msk = _paged_gather(k_pool, v_pool, block_tables, lengths,
                              k_scale, v_scale)
    s = _paged_scores(q, k, msk)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v)
    return o.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def paged_chunk_partials_ref(q, k_pool, v_pool, block_tables, q_pos,
                             lengths, *, k_scale=None, v_scale=None,
                             tree_mask=None):
    """Chunked-prefill partials: C query tokens a row against the paged
    pool (which already holds this chunk's own KV rows), causal-masked per
    query position.

    q: [B, C, H, D]; k/v_pool: [NB, BS, KV, D]; block_tables: [B, MB]
    (entries < 0 absent); q_pos: [B, C] absolute position of each query
    (pad queries may point past `lengths`: their outputs are garbage the
    caller discards); lengths: [B] valid tokens incl. this chunk.
    -> (o [B, C, H, D] fp32 unnormalized, m [B, C, H], l [B, C, H]), the
    contract of `paged_decode_partials_ref`.

    tree_mask: optional [B, C, C] bool ancestor matrix: query node i
    attends the committed prefix (< pos0) plus in-chunk node j iff
    tree_mask[b, i, j].  A lower-triangular tree_mask reproduces the
    causal `pos <= q_pos` mask exactly."""
    B, C, H, D = q.shape
    k, v, msk = _paged_gather(k_pool, v_pool, block_tables, lengths,
                              k_scale, v_scale)
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, C, KV, H // KV, D)
    s = torch.einsum("bckgd,bskd->bckgs", qf, k)               # [B,C,KV,G,S]
    pos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    if tree_mask is not None:
        pos0 = q_pos[:, :1]                                    # [B, 1]
        s_pos = pos[0]                                         # [1, S]
        prefix = s_pos < pos0                                  # [B, S]
        in_chunk = (s_pos >= pos0) & (s_pos < pos0 + C)
        rel = torch.clamp(s_pos - pos0, 0, C - 1)              # [B, S]
        anc = torch.gather(tree_mask, 2, rel[:, None, :].expand(
            B, C, s_pos.shape[1]).long())
        keep = msk[:, None, :] & (prefix[:, None, :]
                                  | (in_chunk[:, None, :] & anc))
    else:
        keep = msk[:, None, :] & (pos <= q_pos[:, :, None])    # [B, C, S]
    s = torch.where(keep[:, :, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bckgs,bskd->bckgd", p, v)
    return (o.reshape(B, C, H, D), m.reshape(B, C, H),
            l.reshape(B, C, H))


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
    emitting `dot_dtype`, bias, activation, cast, residual add).
    `w_scale` ([N] fp32): the per-output-channel scale of an int8 `w`,
    applied to the dot's output in fp32 before the bias."""
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
                            nbeta=None, wg_scale=None, wu_scale=None,
                            residual=None, eps=RMS_EPS, compute_dtype=None,
                            out_dtype=None):
    """silu(norm(x) @ wg) * (norm(x) @ wu) [+ residual] — the exact op
    chain of the unfused gated MLP (normalize, cast to the compute dtype,
    two dots emitting `out_dtype`, fp32 silu-mul, cast, residual add).
    `wg_scale` / `wu_scale`: the per-output-channel scales of int8
    weights, applied in fp32 before the silu gate."""
    h = norm_prologue_ref(x, norm=norm, gamma=gamma, nbeta=nbeta, eps=eps)
    cd = compute_dtype or h.dtype
    od = out_dtype or h.dtype
    a = h.to(cd)
    g = matmul_ref(a, w_gate.to(cd), activation="none", out_dtype=od)
    u = matmul_ref(a, w_up.to(cd), activation="none", out_dtype=od)
    gf, uf = g.float(), u.float()
    if wg_scale is not None:
        gf = gf * wg_scale.float()
        uf = uf * wu_scale.float()
    y = (torch.nn.functional.silu(gf) * uf).to(od)
    if residual is not None:
        y = residual + y
    return y


def expert_swiglu_ref(xe, wg, wu, *, compute_dtype=None, out_dtype=None):
    """silu(xe @ wg) * (xe @ wu) expert by expert — the reference's `ref`
    branch of ops.expert_swiglu: xe [NE, C, K], wg / wu [NE, K, N]; two
    batched dots at the compute dtype with fp32 accumulation, each emitted
    at `out_dtype`, then the silu-mul in fp32 and one cast."""
    out_dtype = out_dtype or xe.dtype
    cd = compute_dtype or xe.dtype
    a = xe.to(cd).float()
    g = torch.matmul(a, wg.to(cd).float()).to(out_dtype)
    u = torch.matmul(a, wu.to(cd).float()).to(out_dtype)
    return (torch.nn.functional.silu(g.float()) * u.float()).to(out_dtype)


def residual_norm_ref(x, y, *, norm, gamma, nbeta=None, eps=RMS_EPS):
    """r = x + y; h = norm(r) — same two ops as the unfused chain.
    -> (h, r)."""
    r = x + y
    return norm_prologue_ref(r, norm=norm, gamma=gamma, nbeta=nbeta,
                             eps=eps), r


# --------------------------------------------------------------------------
# Mamba2 SSD
# --------------------------------------------------------------------------

def ssd_ref(x, dt, A, B, C, D, *, out_dtype=None):
    """Mamba2 SSD oracle — sequential recurrence over time (ground truth).

    x:  [Bt, S, H, P]   (P = head dim)
    dt: [Bt, S, H]      (positive step sizes; pre-softplus'd)
    A:  [H]             (negative decay rates)
    B:  [Bt, S, N]      (input gate,  N = state dim)
    C:  [Bt, S, N]      (output gate)
    D:  [H]             (skip)
    state h: [Bt, H, P, N];  h_t = exp(dt*A) h_{t-1} + dt * x_t B_t^T
                            y_t = h_t C_t + D * x_t
    """
    out_dtype = out_dtype or x.dtype
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf = x.float()
    dtf = dt.float()
    Af, Bf, Cf, Df = (t.float() for t in (A, B, C, D))
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])                  # [Bt, H]
        h = h * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], Bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + Df[None, None, :, None] * xf
    return y.to(out_dtype), h


def ssd_chunked_ref(x, dt, A, B, C, D, *, chunk=64, h0=None, out_dtype=None):
    """Chunk-parallel SSD (the state-space-duality form the kernel uses):
    intra-chunk attention-like matmuls + inter-chunk state recurrence.
    Matches ssd_ref up to fp reordering."""
    out_dtype = out_dtype or x.dtype
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked_ref: chunk {chunk} does not divide "
                         f"S = {S}")
    nc = S // chunk
    xf = x.float().reshape(Bt, nc, chunk, H, P)
    dtf = dt.float().reshape(Bt, nc, chunk, H)
    Bf = B.float().reshape(Bt, nc, chunk, N)
    Cf = C.float().reshape(Bt, nc, chunk, N)
    Af = A.float()

    # cumulative log-decay within each chunk: a[t] = sum_{u<=t} dt_u * A
    da = dtf * Af[None, None, None, :]                    # [Bt,nc,L,H]
    cum = torch.cumsum(da, dim=2)                         # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [Bt,nc,L,L,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay_mat = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))

    # intra-chunk (the "attention-like" quadratic term)
    g = torch.einsum("bcln,bcmn->bclm", Cf, Bf)           # [Bt,nc,L,L]
    m = g[..., None] * decay_mat                          # [Bt,nc,L,L,H]
    y_intra = torch.einsum("bclmh,bcmh,bcmhp->bclhp", m, dtf, xf)

    # chunk-boundary states
    chunk_decay = torch.exp(cum[:, :, -1])                # [Bt,nc,H]
    b_decay = torch.exp(cum[:, :, -1:, :] - cum)          # t -> chunk end
    states = torch.einsum("bclh,bclh,bclhp,bcln->bchpn",
                          b_decay, dtf, xf, Bf)           # [Bt,nc,H,P,N]

    h = (torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                   # entering chunk c

    # inter-chunk contribution
    in_decay = torch.exp(cum)                             # chunk start -> t
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", Cf, in_decay, h_prev)

    y = (y_intra + y_inter).reshape(Bt, S, H, P)
    y = y + D.float()[None, None, :, None] * x.float()
    return y.to(out_dtype), h


def ssd_decode_ref(x, dt, A, B, C, D, h, *, out_dtype=None):
    """Single-step SSD state update (AR decode).
    x: [Bt,H,P], dt: [Bt,H], B,C: [Bt,N], h: [Bt,H,P,N]."""
    out_dtype = out_dtype or x.dtype
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * A.float()[None])
    h = h * decay[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", xf * dtf[..., None], B.float())
    y = torch.einsum("bhpn,bn->bhp", h, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(out_dtype), h

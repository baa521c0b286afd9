"""PyTorch port, kernel level: each kernel's plain PyTorch version (what
the CUDA kernel computes, and what the wrapper runs for CPU tensors) held
against the JAX Pallas kernel in interpret mode and against the reference's
jnp oracle; the ref.py port against the jnp oracle; and the dispatch rules
(no fallback from a kernel to its plain version).

Inputs come from a numpy seed and go to both frameworks.  Tolerances:
fp32 rtol = atol = 1e-4; bf16 the conftest's 2e-2.
"""
import ast
import itertools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.kernels import matmul as jmm
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jnorm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as tnorm

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch tensor."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return jnp.asarray(arr, jnp.float32).astype(jd), torch.tensor(arr).to(td)


# --------------------------------------------------------------------------
# fused GEMM
# --------------------------------------------------------------------------

def _mm_inputs(seed, M=24, K=64, N=48, dtype="f32"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    g = (1.0 + 0.2 * rng.standard_normal(K)).astype(np.float32)
    b = (0.2 * rng.standard_normal(K)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return [_pair(x, dtype) for x in (a, w, g, b, res)]


def _mm_kwargs(norm, epilogue, g, b, res):
    kw = dict(norm=norm, eps=1e-5 if norm == "layernorm" else 1e-6)
    if norm != "none":
        kw["gamma"] = g
    if norm == "layernorm":
        kw["nbeta"] = b
    if epilogue == "i_gelu":
        kw["activation"] = "i_gelu"
    if epilogue == "residual":
        kw["residual"] = res
    return kw


@pytest.mark.parametrize("epilogue", ["none", "i_gelu", "residual"])
@pytest.mark.parametrize("norm", ["none", "layernorm", "rmsnorm"])
def test_fused_matmul_plain_vs_pallas_and_oracle(norm, epilogue):
    (ja, ta), (jw, tw), (jg, tg), (jb, tb), (jr, tr) = _mm_inputs(0)
    got = tmm.matmul_plain(ta, tw, **_mm_kwargs(norm, epilogue, tg, tb, tr))
    pallas = jmm.matmul(ja, jw, block_m=16, block_n=16, block_k=32,
                        interpret=True,
                        **_mm_kwargs(norm, epilogue, jg, jb, jr))
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)
    oracle = jref.fused_matmul_ref(ja, jw, dot_dtype=jnp.float32,
                                   out_dtype=jnp.float32,
                                   **_mm_kwargs(norm, epilogue, jg, jb, jr))
    np.testing.assert_allclose(_np(got), _np(oracle), **F32)


@pytest.mark.parametrize("norm", ["none", "layernorm"])
def test_fused_matmul_plain_vs_pallas_bf16(norm):
    """bf16 operands: the plain version repeats the Pallas kernel's fp32
    prologue arithmetic, so the two agree to a bf16 output ulp."""
    (ja, ta), (jw, tw), (jg, tg), (jb, tb), (jr, tr) = _mm_inputs(1,
                                                                  dtype="bf16")
    kw = _mm_kwargs(norm, "residual", tg, tb, tr)
    got = tmm.matmul_plain(ta, tw, activation="i_gelu", **kw)
    pallas = jmm.matmul(ja, jw, activation="i_gelu", block_m=16, block_n=16,
                        block_k=32, interpret=True,
                        **_mm_kwargs(norm, "residual", jg, jb, jr))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(pallas), **BF16)


@pytest.mark.parametrize("norm", ["none", "rmsnorm", "layernorm"])
def test_fused_matmul_ref_port_matches_oracle_bf16(norm):
    """ref.py port: same casts as the jnp oracle (normalize, cast, dot to
    bf16, activation, residual)."""
    (ja, ta), (jw, tw), (jg, tg), (jb, tb), (jr, tr) = _mm_inputs(2,
                                                                  dtype="bf16")
    got = tref.fused_matmul_ref(ta, tw, activation="i_gelu",
                                compute_dtype=torch.bfloat16,
                                **_mm_kwargs(norm, "residual", tg, tb, tr))
    want = jref.fused_matmul_ref(ja, jw, activation="i_gelu",
                                 compute_dtype=jnp.bfloat16,
                                 **_mm_kwargs(norm, "residual", jg, jb, jr))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("mode", ["auto", "ref"])
@pytest.mark.parametrize("activation", ["none", "gelu"])
def test_ops_matmul_matches_oracle(mode, activation):
    (ja, ta), (jw, tw), _, _, _ = _mm_inputs(6)
    with ops.kernel_mode(mode):
        got = ops.matmul(ta.reshape(2, 12, 64), tw, activation=activation)
    want = jref.matmul_ref(ja, jw, activation=activation)
    assert got.shape == (2, 12, 48)
    np.testing.assert_allclose(_np(got).reshape(24, 48), _np(want), **F32)


def test_fused_matmul_wrapper_takes_plain_on_cpu():
    (_, ta), (_, tw), (_, tg), (_, tb), _ = _mm_inputs(3)
    before = tmm.fused_matmul.launches
    got = tmm.fused_matmul(ta, tw, norm="layernorm", gamma=tg, nbeta=tb,
                           eps=1e-5)
    want = tmm.matmul_plain(ta, tw, norm="layernorm", gamma=tg, nbeta=tb,
                            eps=1e-5)
    assert torch.equal(got, want)
    assert tmm.fused_matmul.launches == before     # no kernel launched


# --------------------------------------------------------------------------
# fused gated GEMM (SwiGLU)
# --------------------------------------------------------------------------

def _swiglu_inputs(seed, dtype, M=24, K=64, N=48):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(np.float32)
    wg, wu = ((rng.standard_normal((K, N)) * 0.2).astype(np.float32)
              for _ in range(2))
    g = (1.0 + 0.2 * rng.standard_normal(K)).astype(np.float32)
    b = (0.2 * rng.standard_normal(K)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return [_pair(x, dtype) for x in (a, wg, wu, g, b, res)]


def _swiglu_kwargs(norm, residual, g, b, res):
    kw = _mm_kwargs(norm, "none", g, b, res)
    if residual:
        kw["residual"] = res
    return kw


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("norm", ["none", "rmsnorm", "layernorm"])
def test_matmul_swiglu_plain_vs_pallas_and_oracle(norm, residual, dtype):
    """The plain version repeats the Pallas kernel's arithmetic (fp32
    prologue, two fp32 accumulators, fp32 silu-mul): fp32 within 1e-4 of
    the kernel in interpret mode; bf16 within a bf16 output ulp.  Against
    the jnp oracle (normalize, cast, dot) the same in fp32."""
    (ja, ta), (jwg, twg), (jwu, twu), (jg, tg), (jb, tb), (jr, tr) = \
        _swiglu_inputs(10, dtype)
    got = tmm.matmul_swiglu_plain(ta, twg, twu, **_swiglu_kwargs(
        norm, residual, tg, tb, tr))
    pallas = jmm.matmul_swiglu(ja, jwg, jwu, block_m=16, block_n=16,
                               block_k=32, interpret=True,
                               **_swiglu_kwargs(norm, residual, jg, jb, jr))
    tol = F32 if dtype == "f32" else BF16
    assert got.dtype == ta.dtype
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    if dtype == "f32":
        oracle = jref.fused_matmul_swiglu_ref(
            ja, jwg, jwu, out_dtype=jnp.float32,
            **_swiglu_kwargs(norm, residual, jg, jb, jr))
        np.testing.assert_allclose(_np(got), _np(oracle), **F32)


@pytest.mark.parametrize("norm", ["none", "rmsnorm", "layernorm"])
def test_fused_matmul_swiglu_ref_port_matches_oracle_bf16(norm):
    """ref.py port: same casts as the jnp oracle (normalize, cast to bf16,
    two dots emitting bf16, fp32 silu-mul, cast, residual)."""
    (ja, ta), (jwg, twg), (jwu, twu), (jg, tg), (jb, tb), (jr, tr) = \
        _swiglu_inputs(11, "bf16")
    got = tref.fused_matmul_swiglu_ref(
        ta, twg, twu, compute_dtype=torch.bfloat16,
        **_swiglu_kwargs(norm, True, tg, tb, tr))
    want = jref.fused_matmul_swiglu_ref(
        ja, jwg, jwu, compute_dtype=jnp.bfloat16,
        **_swiglu_kwargs(norm, True, jg, jb, jr))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_swiglu_entry_points_match_reference_ops(mode):
    """`ops.matmul_swiglu` / `ops.fused_matmul_swiglu` in both modes
    against the reference's `ops` entry points on their CPU path."""
    from repro.kernels import ops as jops
    (ja, ta), (jwg, twg), (jwu, twu), (jg, tg), _, (jr, tr) = \
        _swiglu_inputs(12, "f32")
    with ops.kernel_mode(mode):
        got = ops.matmul_swiglu(ta, twg, twu)
        got_f = ops.fused_matmul_swiglu(
            ta.reshape(2, 12, 64), twg, twu,
            prologue=ops.Prologue("rmsnorm", tg), residual=tr.reshape(
                2, 12, 48), compute_dtype=torch.float32,
            out_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(jops.matmul_swiglu(ja, jwg, jwu)),
                               **F32)
    want_f = jops.fused_matmul_swiglu(
        ja, jwg, jwu, prologue=jops.Prologue("rmsnorm", jg), residual=jr,
        compute_dtype=jnp.float32, out_dtype=jnp.float32)
    assert got_f.shape == (2, 12, 48)
    np.testing.assert_allclose(_np(got_f).reshape(24, 48), _np(want_f),
                               **F32)


def test_matmul_swiglu_wrapper_takes_plain_on_cpu():
    (_, ta), (_, twg), (_, twu), (_, tg), (_, tb), _ = _swiglu_inputs(13,
                                                                     "f32")
    before = tmm.matmul_swiglu.launches
    got = tmm.matmul_swiglu(ta, twg, twu, norm="layernorm", gamma=tg,
                            nbeta=tb, eps=1e-5)
    want = tmm.matmul_swiglu_plain(ta, twg, twu, norm="layernorm", gamma=tg,
                                   nbeta=tb, eps=1e-5)
    assert torch.equal(got, want)
    assert tmm.matmul_swiglu.launches == before     # no kernel launched


# --------------------------------------------------------------------------
# row norms
# --------------------------------------------------------------------------

NORM_CASES = [(kind, dtype, D) for D in (96, 1600, 2560)
              for kind in ("rmsnorm", "layernorm") for dtype in ("f32", "bf16")]


@pytest.mark.parametrize(
    "kind,dtype,D", NORM_CASES,
    ids=[f"{k}-{t}" + ("" if D == 96 else f"-D{D}") for k, t, D in NORM_CASES])
def test_norm_plain_vs_pallas_and_oracle(kind, dtype, D):
    """[3, 7, D] rows (21 rows against the kernel's 8-row blocks); D = 96,
    and hymba's (1600) and mamba2's (2560) widths."""
    rng = np.random.default_rng(20)
    x = (rng.standard_normal((3, 7, D)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(v, dtype) for v in (x, g, b))
    tol = F32 if dtype == "f32" else BF16
    if kind == "rmsnorm":
        got = tnorm.rmsnorm(tx, tg)
        pallas = jnorm.rmsnorm(jx, jg, block_rows=8, interpret=True)
        oracle = jref.rmsnorm_ref(jx, jg)
        port_ref = tref.rmsnorm_ref(tx, tg)
    else:
        got = tnorm.layernorm(tx, tg, tb)
        pallas = jnorm.layernorm(jx, jg, jb, block_rows=8, interpret=True)
        oracle = jref.layernorm_ref(jx, jg, jb)
        port_ref = tref.layernorm_ref(tx, tg, tb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    np.testing.assert_allclose(_np(port_ref), _np(oracle), **tol)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_norm_dispatch(mode):
    """`ops.norm` routes both kinds; in `auto` on the CPU through the
    kernel wrappers' plain versions (no launch), in `ref` through ref.py."""
    rng = np.random.default_rng(21)
    x = torch.tensor(rng.standard_normal((5, 32)).astype(np.float32))
    p = {"scale": torch.tensor(1 + 0.1 * rng.standard_normal(32)).float(),
         "bias": torch.tensor(0.1 * rng.standard_normal(32)).float()}
    before = (tnorm.rmsnorm.launches, tnorm.layernorm.launches)
    with ops.kernel_mode(mode):
        rms = ops.norm(x, p, "rmsnorm")
        ln = ops.norm(x, p, "layernorm")
    assert (tnorm.rmsnorm.launches, tnorm.layernorm.launches) == before
    want_rms = tnorm.rmsnorm_plain(x, p["scale"]) if mode == "auto" else \
        tref.rmsnorm_ref(x, p["scale"])
    assert torch.equal(rms, want_rms)
    np.testing.assert_allclose(
        _np(ln), _np(tref.layernorm_ref(x, p["scale"], p["bias"])), **F32)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("causal,Sq,Skv,q_offset", [
    (True, 20, 20, 0),        # causal, ragged against the 8-wide tiles
    (False, 13, 20, 0),       # ragged kv_len, bidirectional
    (True, 8, 20, 12),        # q rows at an offset (chunk-style)
])
def test_flash_attention_plain_vs_pallas_and_oracle(D, causal, Sq, Skv,
                                                    q_offset):
    rng = np.random.default_rng(D + Sq)
    q = rng.standard_normal((2, Sq, 4, D)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, D)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "f32") for x in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                    q_offset=q_offset, block_kv=8)
    pallas = jfa.flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                                 block_q=8, block_kv=8, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(oracle), **F32)
    np.testing.assert_allclose(
        _np(tref.attention_ref(tq, tk, tv, causal=causal, q_offset=q_offset)),
        _np(oracle), **F32)
    port_ref = tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        q_offset=q_offset, block_kv=8)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        q_offset=q_offset, block_kv=8)
    np.testing.assert_allclose(_np(port_ref), _np(want_ref), **F32)


def test_flash_attention_plain_vs_pallas_bf16():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 24, 2, 32)).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "bf16") for x in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=True)
    pallas = jfa.flash_attention(jq, jk, jv, causal=True, block_q=8,
                                 block_kv=8, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(pallas), **BF16)


# --------------------------------------------------------------------------
# paged decode
# --------------------------------------------------------------------------

def _paged_inputs(seed, dtype="f32"):
    """3 slots, mixed lengths, an absent entry inside slot 1's table and
    unallocated tails."""
    rng = np.random.default_rng(seed)
    B, H, KV, D, BS, NB, MB = 3, 4, 2, 16, 8, 12, 5
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    tab = np.array([[3, 7, -1, -1, -1],
                    [1, -1, 4, 9, -1],
                    [11, 0, 2, 5, 6]], np.int32)
    lengths = np.array([13, 30, 37], np.int32)
    pairs = [_pair(x, dtype) for x in (q, kp, vp)]
    jt, tt = jnp.asarray(tab), torch.tensor(tab)
    jl, tl = jnp.asarray(lengths), torch.tensor(lengths)
    return pairs, (jt, tt), (jl, tl)


def test_paged_decode_partials_plain_vs_pallas_and_oracle():
    ((jq, tq), (jk, tk), (jv, tv)), (jt, tt), (jl, tl) = _paged_inputs(0)
    o, m, l = tfd.paged_decode_partials(tq, tk, tv, tt, tl)
    po, pm, pl_ = jfd.paged_decode_partials(jq, jk, jv, jt, jl,
                                            interpret=True)
    for a, b in ((o, po), (m, pm), (l, pl_)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    ro, rm, rl = jref.paged_decode_partials_ref(jq, jk, jv, jt, jl)
    # the oracle's (m, l) are the whole-row statistics: compare normalized
    np.testing.assert_allclose(_np(o / l[..., None]),
                               _np(ro / rl[..., None]), **F32)
    to, tm_, tl_ = tref.paged_decode_partials_ref(tq, tk, tv, tt, tl)
    for a, b in ((to, ro), (tm_, rm), (tl_, rl)):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_attention_plain_vs_pallas_and_oracle(dtype):
    ((jq, tq), (jk, tk), (jv, tv)), (jt, tt), (jl, tl) = _paged_inputs(
        1, dtype)
    got = tfd.paged_decode_attention(tq, tk, tv, tt, tl)
    pallas = jfd.paged_decode_attention(jq, jk, jv, jt, jl, interpret=True)
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    oracle = jref.paged_decode_attention_ref(jq, jk, jv, jt, jl)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    port_ref = tref.paged_decode_attention_ref(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(_np(port_ref), _np(oracle), **tol)


def _split_route(q, k, v, tables, lengths, splits):
    """The partials over `splits` table ranges, merged by the
    online-softmax rule."""
    o, m, l = ops.paged_decode_partials(q, k, v, tables, lengths,
                                        splits=splits)
    return ops.paged_decode_merge(o, m, l, out_dtype=q.dtype)


def test_split_kv_merge_matches_single_pass():
    """The split-KV partials over table ranges, then the online-softmax
    merge, equal the decode path's one paged route (which splits as the
    shapes say) and so the single normalized pass."""
    pairs, (_, tt), (_, tl) = _paged_inputs(2)
    tq, tk, tv = (t for _, t in pairs)
    one = ops.paged_decode_attention(tq, tk, tv, tt, tl)
    for splits in (2, 3, 5):
        np.testing.assert_allclose(
            _np(_split_route(tq, tk, tv, tt, tl, splits)), _np(one), **F32)


def _split_inputs(seed):
    """4 slots over 9 table entries of 4-token blocks: a hole inside slot
    1, length 1 (slot 0), a slot whose later ranges lie wholly past its
    length (slot 2), and a full slot (slot 3)."""
    rng = np.random.default_rng(seed)
    B, H, KV, D, BS, NB, MB = 4, 4, 2, 16, 4, 40, 9
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    tab = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    tab[0, 1:] = -1
    tab[1, 3] = -1
    tab[1, 6:] = -1
    tab[2, 3:] = rng.permutation(NB)[:MB - 3]   # allocated, past the length
    lengths = np.array([1, 23, 10, 36], np.int32)
    pairs = [_pair(x, "f32") for x in (q, kp, vp)]
    return pairs, (jnp.asarray(tab), torch.tensor(tab)), (
        jnp.asarray(lengths), torch.tensor(lengths))


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_paged_partials_plain_vs_pallas(splits):
    """The paged kernel's split grid on the CPU: each split's partials are
    the Pallas partials kernel (interpret mode) over the table with the
    entries outside the split's range absent; the merged splits equal the
    single pass, `paged_decode_plain`, and the Pallas attention kernel."""
    ((jq, tq), (jk, tk), (jv, tv)), (jt, tt), (jl, tl) = _split_inputs(
        10 + splits)
    o, m, l = tfd.paged_decode_partials(tq, tk, tv, tt, tl, splits)
    lead = (splits,) if splits > 1 else ()
    assert o.shape == (*lead, 4, 4, 16) and m.shape == l.shape == (*lead,
                                                                   4, 4)
    ranges = tfd.split_ranges(tt.shape[1], splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == tt.shape[1]
    for z, (e0, e1) in enumerate(ranges):
        keep = np.zeros(tt.shape[1], bool)
        keep[e0:e1] = True
        jtz = jnp.where(jnp.asarray(keep)[None, :], jt, -1)
        po, pm, pl_ = jfd.paged_decode_partials(jq, jk, jv, jtz, jl,
                                                interpret=True)
        got = (o, m, l) if splits == 1 else (o[z], m[z], l[z])
        # a slot with no live entry in this range: the kernels' empty state
        # (m = -1e30, l = 0, o = 0) where the oracle-free Pallas kernel
        # reports its own init; compare the live slots' statistics
        live = np.asarray([(np.asarray(jtz)[b] >= 0).any()
                           and e0 * 4 < int(tl[b]) for b in range(4)])
        for a, b in zip(got, (po, pm, pl_)):
            np.testing.assert_allclose(_np(a)[live], _np(b)[live], **F32)
        assert (_np(got[2])[~live] == 0).all()
    merged = (tfd.paged_decode_merge_plain(o, m, l, out_dtype=torch.float32)
              if splits > 1 else o / l[..., None])
    one_o, _, one_l = tfd.paged_decode_plain(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(_np(merged), _np(one_o / one_l[..., None]),
                               **F32)
    pallas = jfd.paged_decode_attention(jq, jk, jv, jt, jl, interpret=True)
    np.testing.assert_allclose(_np(merged), _np(pallas), **F32)


def test_paged_splits_rule():
    """Two blocks per SM over the (KV, B) grid, at least the caller's
    count, each split at least 4 table entries, at most 64 splits."""
    assert tfd.paged_splits(4, 16, 32, sms=132) == 5       # GPT-J serve
    assert tfd.paged_splits(4, 8, 32, sms=132) == 8        # capped: 32 / 4
    assert tfd.paged_splits(4, 16, 128, sms=132, at_least=8) == 8
    assert tfd.paged_splits(4, 16, 8, sms=132, at_least=3) == 3
    assert tfd.paged_splits(64, 16, 32, sms=132) == 1
    assert tfd.paged_splits(1, 1, 4096, sms=132) == tfd.MAX_MERGE_SPLITS


def test_dense_splits_rule():
    """The dense kernel's split ranges: whole 32-position stages, every
    position of [lo, len) in exactly one split (ring caches: lo = 0; linear
    caches with a window: lo = len - window), at most 64 splits, and at
    least two blocks an SM over the (KV, B) grid at gemma3's (KV 16, a ring
    and a windowed linear cache) and hymba's (KV 5) decode shapes."""
    shapes = ((4, 16, 1024), (4, 5, 1024), (4, 16, 2048), (1, 1, 4096),
              (64, 16, 1024), (4, 8, 37), (3, 2, 100))
    for (B, KV, S), window in itertools.product(shapes, (0, 1024, 30)):
        n = tfd.dense_splits(B, KV, S, sms=132, window=window)
        rng = tfd.dense_range(S, n)
        assert 1 <= n <= tfd.MAX_MERGE_SPLITS and rng % tfd.STAGE == 0
        assert n * rng >= S
        for length in (S, 1, S // 3 + 1, S // 2 + 5, 0):
            lo = max(0, length - window) if window else 0
            hits = np.zeros(S, np.int64)
            for z in range(n):       # the kernel's block z: [first, end)
                first, end = max(z * rng, lo), min((z + 1) * rng, length)
                hits[first:max(first, end)] += 1
            assert (hits[lo:length] == 1).all(), (B, KV, S, length, window)
            assert hits[:lo].sum() == 0 and hits[length:].sum() == 0
    for KV, S, window in ((16, 1024, 0), (5, 1024, 0), (16, 2048, 1024)):
        n = tfd.dense_splits(4, KV, S, sms=132, window=window)
        rng = tfd.dense_range(S, n)
        live = -(-min(S, window or S) // rng)    # ranges a full slot reaches
        assert 4 * KV * live >= 2 * 132, (KV, S, window, n)
    assert tfd.dense_splits(4, 16, 1024, sms=132) == 11
    assert tfd.dense_splits(4, 5, 1024, sms=132) == 32
    assert tfd.dense_splits(4, 16, 2048, sms=132, window=1024) == 22
    assert tfd.dense_splits(64, 16, 1024, sms=132) == 1
    assert tfd.dense_splits(1, 1, 4096, sms=132) == tfd.MAX_MERGE_SPLITS


def test_paged_attention_plain_splits_as_the_card_does():
    """The normalized wrapper's plain version splits the table as the
    kernel's grid does (`paged_splits`) and merges: within fp32 rounding of
    the single pass."""
    pairs, (_, tt), (_, tl) = _split_inputs(5)
    tq, tk, tv = (t for _, t in pairs)
    S = tfd.paged_splits(4, 2, tt.shape[1])
    assert S > 1
    got = tfd.paged_decode_attention(tq, tk, tv, tt, tl)
    o, m, l = tfd.paged_decode_plain(tq, tk, tv, tt, tl, S)
    assert torch.equal(got, tfd.paged_decode_merge_plain(
        o, m, l, out_dtype=torch.float32))
    one_o, _, one_l = tfd.paged_decode_plain(tq, tk, tv, tt, tl)
    np.testing.assert_allclose(_np(got), _np(one_o / one_l[..., None]),
                               **F32)


def test_paged_attention_plain_at_one_split_merges():
    """Where the (KV, B) grid fills the card by itself (`paged_splits` ==
    1) the normalized wrapper still folds into partials and merges them,
    as the kernel does: equal to the merge of the one-split partials and
    within fp32 rounding of the JAX oracle."""
    rng = np.random.default_rng(9)
    B, H, KV, D, BS, MB = 17, 16, 16, 8, 4, 3
    NB = B * MB
    assert tfd.paged_splits(B, KV, MB) == 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
              for _ in range(2))
    tab = rng.permutation(NB).reshape(B, MB).astype(np.int32)
    lengths = rng.integers(1, MB * BS + 1, B).astype(np.int32)
    tab[3, 1] = -1                                  # a hole
    tq, tk, tv, tt, tl = (torch.tensor(x) for x in (q, kp, vp, tab,
                                                     lengths))
    got = tfd.paged_decode_attention(tq, tk, tv, tt, tl)
    o, m, l = tfd.paged_decode_plain(tq, tk, tv, tt, tl)
    assert torch.equal(got, tfd.paged_decode_merge_plain(
        o[None], m[None], l[None], out_dtype=torch.float32))
    want = jref.paged_decode_attention_ref(*(jnp.asarray(x) for x in (
        q, kp, vp, tab, lengths)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_paged_decode_merge_plain_is_the_merge_rule():
    """The merge kernel's plain version against the rule written out per
    (slot, head) in numpy: sum_s o_s e^(m_s - m) / sum_s l_s e^(m_s - m),
    m = max_s m_s; an empty split (m = -1e30, l = 0) drops out."""
    rng = np.random.default_rng(7)
    o = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    m = rng.standard_normal((3, 2, 4)).astype(np.float32)
    l = rng.uniform(0.5, 4, (3, 2, 4)).astype(np.float32)
    m[1, 0], l[1, 0], o[1, 0] = -1e30, 0.0, 0.0
    want = np.zeros((2, 4, 16), np.float32)
    for b in range(2):
        for h in range(4):
            w = np.exp(m[:, b, h] - m[:, b, h].max())
            want[b, h] = (w[:, None] * o[:, b, h]).sum(0) / (
                w * l[:, b, h]).sum()
    to, tm_, tl_ = (torch.tensor(x) for x in (o, m, l))
    got = tfd.paged_decode_merge(to, tm_, tl_, out_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), want, **F32)
    assert torch.equal(tfd.paged_decode_merge(to, tm_, tl_,
                                              out_dtype=torch.bfloat16),
                       got.bfloat16())


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_split_partials_modes(mode):
    """`ops.paged_decode_partials` with a split count: the plain split grid
    (auto) and the oracle per range (ref) agree, and the merge folds
    either into the decode path's one paged route."""
    pairs, (_, tt), (_, tl) = _split_inputs(3)
    tq, tk, tv = (t for _, t in pairs)
    with ops.kernel_mode(mode):
        o, m, l = ops.paged_decode_partials(tq, tk, tv, tt, tl, splits=3)
        one = ops.paged_decode_attention(tq, tk, tv, tt, tl)
        three = _split_route(tq, tk, tv, tt, tl, 3)
    po, pm, pl_ = tfd.paged_decode_plain(tq, tk, tv, tt, tl, 3)
    assert o.shape == (3, 4, 4, 16)
    # ranges with no live entry: the oracle's fully masked rows differ
    # (ROADMAP queue 3) and carry m = -1e30, so the merge drops them
    live = _np(pl_) > 0
    np.testing.assert_allclose(_np(o / l[..., None])[live],
                               _np(po / pl_[..., None])[live], **F32)
    np.testing.assert_allclose(_np(m)[live], _np(pm)[live], **F32)
    np.testing.assert_allclose(_np(three), _np(one), **F32)


# --------------------------------------------------------------------------
# dispatch: no fallback, validated modes
# --------------------------------------------------------------------------

def test_invalid_env_mode_raises(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_MODE", "pallas")
    with pytest.raises(ValueError, match="not a valid kernel mode"):
        ops.get_mode()


def test_cuda_mode_refuses_cpu_tensor():
    x = torch.zeros((2, 8))
    w = torch.zeros((8, 4))
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.fused_matmul(x, w)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.flash_attention(torch.zeros((1, 4, 2, 8)),
                                torch.zeros((1, 4, 2, 8)),
                                torch.zeros((1, 4, 2, 8)))


def test_auto_mode_non_cpu_tensor_raises_instead_of_falling_back():
    """A tensor that is not on the CPU goes to the kernel; where no kernel
    can launch the call raises — it never quietly runs the plain version."""
    q = torch.zeros((1, 4, 2, 8), device="meta")
    with ops.kernel_mode("auto"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            ops.fused_matmul(torch.zeros((2, 8), device="meta"),
                             torch.zeros((8, 4), device="meta"))
        pools = torch.zeros((3, 4, 2, 8), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            ops.paged_decode_partials(
                torch.zeros((1, 2, 8), device="meta"), pools, pools,
                torch.zeros((1, 2), dtype=torch.int32, device="meta"),
                torch.ones((1,), dtype=torch.int32, device="meta"))


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("op", ["matmul_swiglu", "fused_matmul_swiglu",
                                "rmsnorm", "layernorm", "decode_attention",
                                "paged_decode_merge", "pdot"])
def test_new_ops_never_fall_back(op):
    """The gated GEMM, the norms and the dense decode attention: `cuda`
    mode refuses a CPU tensor, and a tensor off the CPU with no kernel to
    launch raises — neither quietly runs the plain version."""
    calls = {
        "matmul_swiglu": lambda t: ops.matmul_swiglu(t(2, 8), t(8, 4),
                                                     t(8, 4)),
        "fused_matmul_swiglu": lambda t: ops.fused_matmul_swiglu(
            t(2, 8), t(8, 4), t(8, 4), prologue=ops.Prologue("rmsnorm",
                                                             t(8))),
        "rmsnorm": lambda t: ops.rmsnorm(t(2, 8), t(8)),
        "layernorm": lambda t: ops.layernorm(t(2, 8), t(8), t(8)),
        "decode_attention": lambda t: ops.decode_attention(
            t(1, 2, 8), t(1, 4, 2, 8), t(1, 4, 2, 8), t(1), window=2),
        "paged_decode_merge": lambda t: ops.paged_decode_merge(
            t(2, 1, 2, 8), t(2, 1, 2), t(2, 1, 2), out_dtype=torch.float32),
        "pdot": lambda t: ops.pdot(t(2, 8), t(8, 4),
                                   compute_dtype=torch.bfloat16,
                                   out_dtype=torch.float32),
    }[op]
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            calls(lambda *s: torch.zeros(s))
    with ops.kernel_mode("auto"):
        with pytest.raises(ValueError, match="CUDA"):
            calls(_meta)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_wrapper_refuses_what_the_kernel_does_not_take(kind):
    """The norm wrappers' lighter host path keeps its checks: `cuda` mode
    refuses a CPU tensor, a gamma (or beta) not shaped [D] raises before
    anything launches, and a tensor off the CPU with no kernel to launch
    raises — none of them quietly runs the plain version."""
    args = {"rmsnorm": lambda t, gs, bs: (t(2, 8), t(*gs)),
            "layernorm": lambda t, gs, bs: (t(2, 8), t(*gs), t(*bs))}[kind]
    cpu = lambda *s: torch.zeros(s)
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            getattr(ops, kind)(*args(cpu, (8,), (8,)))
    wrapper = getattr(tnorm, kind)
    before = wrapper.launches
    with pytest.raises(ValueError, match="gamma"):
        wrapper(*args(_meta, (7,), (8,)))
    if kind == "layernorm":
        with pytest.raises(ValueError, match="gamma"):
            wrapper(*args(_meta, (8,), (8, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args(_meta, (8,), (8,)))
    assert wrapper.launches == before


def test_ref_mode_runs_ref_port():
    (_, ta), (_, tw), _, _, _ = _mm_inputs(4)
    with ops.kernel_mode("ref"):
        got = ops.fused_matmul(ta, tw, dot_dtype=torch.float32)
    assert torch.equal(got, tref.fused_matmul_ref(ta, tw,
                                                  dot_dtype=torch.float32))


def test_decode_attention_modes():
    """`ref` runs the oracle; `auto` on CPU tensors the kernel's plain
    version (512-position chunks), which agrees with it."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((3, 4, 16), (3, 600, 2, 16), (3, 600, 2, 16)))
    ln = torch.tensor([1, 333, 600])
    with ops.kernel_mode("ref"):
        got = ops.decode_attention(q, k, v, ln, window=100)
    assert torch.equal(got, tref.decode_attention_ref(q, k, v, ln,
                                                      window=100))
    with ops.kernel_mode("auto"):
        plain = ops.decode_attention(q, k, v, ln, window=100)
    assert torch.equal(plain, tfd.decode_attention_plain(q, k, v, ln,
                                                         window=100))
    np.testing.assert_allclose(_np(plain), _np(got), **F32)


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"] + sorted(ROOT.glob("*_probe.py"))
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)

"""PyTorch port: the fused GEMMs' Hopper templates (csrc/gemm.cuh), on the
CPU.

The CUDA templates run only on the card; here their arithmetic is held in
plain PyTorch (`gemm_emulate`: the stream template's K split into uneven
ranges, each split's partial acc, sum x, sum x^2, gamma@W and beta@W added
in split order before the norm; the wgmma template's bf16 rounding of
x * gamma, or its bf16 hi + lo split for an fp32 output) against the Pallas
kernels in interpret mode and against `matmul_plain`, and the planner is
held to every fused GEMM shape of the five served configurations.

Inputs are bf16 values made from a numpy seed and handed to both
frameworks.  Tolerances: fp32 output rtol = atol = 1e-5 element by element
(the stream template's fp32 arithmetic and the wgmma template's hi + lo
split, ~4e-6 per operand); bf16 output max|got - want| <= 2e-2 x
max|want| (one bf16 rounding of x * gamma, then of the output; the
measure chip_smoke.py holds the kernels to on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as jmm
from repro_torch.configs import (GEMMA3_27B, GPT_J, HYMBA_1_5B, MAMBA2_2_7B,
                                 PHI4_MINI)
from repro_torch.kernels import matmul as tmm

torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2
K, N = 200, 48
KCHUNK = {"stream": 56, "wgmma": 128}   # splits of 56 x 3 + 32, 128 + 72 rows
SERVED = (GPT_J, PHI4_MINI, HYMBA_1_5B, MAMBA2_2_7B, GEMMA3_27B)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(seed, M):
    """bf16 A [M, K], gate / up weights [K, N], gamma, beta, residual: the
    same values as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((M, K)),
            rng.standard_normal((K, N)) * 0.2,
            rng.standard_normal((K, N)) * 0.2,
            1.0 + 0.2 * rng.standard_normal(K),
            0.2 * rng.standard_normal(K),
            rng.standard_normal((M, N))]
    return [(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16),
             torch.tensor(x, dtype=torch.float32).bfloat16()) for x in arrs]


def _kwargs(norm, g, b, res):
    kw = dict(norm=norm, gamma=g, residual=res,
              eps=1e-5 if norm == "layernorm" else 1e-6)
    if norm == "layernorm":
        kw["nbeta"] = b
    return kw


def _plan(M, gated=False):
    template = "stream" if M <= tmm.STREAM_MAX_M else "wgmma"
    plan = tmm.gemm_plan(M, K, N, gated=gated, kchunk=KCHUNK[template])
    assert plan.template == template
    return plan


def test_k_ranges_cover_k_in_split_order():
    assert _plan(4).k_ranges(K) == [(0, 56), (56, 112), (112, 168),
                                    (168, 200)]
    assert _plan(70).k_ranges(K) == [(0, 128), (128, 200)]


@pytest.mark.parametrize("M", [1, 4, 17, 70])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_emulated_gemm_fp32_out_vs_plain_and_pallas(M, norm):
    """fp32 output (the logits head): the stream template's split sums and
    the wgmma template's hi + lo products stay within 1e-5 of the plain
    fp32 function and of the Pallas kernel."""
    (ja, ta), (jw, tw), _, (jg, tg), (jb, tb), (jr, tr) = _inputs(M, M)
    kw = dict(activation="i_gelu", out_dtype=torch.float32)
    got = tmm.gemm_emulate(ta, tw, plan=_plan(M), **kw,
                           **_kwargs(norm, tg, tb, tr))
    plain = tmm.matmul_plain(ta, tw, **kw, **_kwargs(norm, tg, tb, tr))
    np.testing.assert_allclose(_np(got), _np(plain), **F32)
    pallas = jmm.matmul(ja, jw, activation="i_gelu", out_dtype=jnp.float32,
                        block_m=16, block_n=16, block_k=32, interpret=True,
                        **_kwargs(norm, jg, jb, jr))
    np.testing.assert_allclose(_np(got), _np(pallas), **F32)


@pytest.mark.parametrize("M", [1, 4, 17, 70])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_emulated_gemm_bf16_out_vs_plain_and_pallas(M, norm):
    """bf16 output: the wgmma template rounds x * gamma to bf16 once (M >
    8); both templates stay within a bf16 step of the plain function and
    the Pallas kernel."""
    (ja, ta), (jw, tw), _, (jg, tg), (jb, tb), (jr, tr) = _inputs(10 + M, M)
    kw = _kwargs(norm, tg, tb, tr)
    got = tmm.gemm_emulate(ta, tw, plan=_plan(M), activation="i_gelu", **kw)
    assert got.dtype == torch.bfloat16
    plain = tmm.matmul_plain(ta, tw, activation="i_gelu", **kw)
    _close_bf16(got, plain)
    pallas = jmm.matmul(ja, jw, activation="i_gelu", block_m=16, block_n=16,
                        block_k=32, interpret=True,
                        **_kwargs(norm, jg, jb, jr))
    _close_bf16(got, pallas)


def test_wgmma_rounds_x_gamma_once_for_bf16_out():
    """The wgmma template's bf16-output product is the product of
    bf16(x * gamma); the stream template's is exact fp32."""
    (_, ta), (_, tw), _, (_, tg), _, _ = _inputs(3, 17)
    kw = dict(norm="rmsnorm", gamma=tg, eps=1e-6, out_dtype=torch.float32)
    xg = (ta.float() * tg.float()).bfloat16()
    rstd = torch.rsqrt((ta.float() ** 2).sum(-1, keepdim=True) / K + 1e-6)
    want = (xg.float() @ tw.float()) * rstd
    bf16_plan = tmm.gemm_plan(17, K, N)
    got = tmm.gemm_emulate(ta, tw, plan=bf16_plan,
                           **{**kw, "out_dtype": torch.bfloat16})
    np.testing.assert_allclose(_np(got), _np(want.bfloat16()), rtol=0,
                               atol=0)
    exact = tmm.gemm_emulate(ta[:4], tw, plan=tmm.gemm_plan(4, K, N), **kw)
    np.testing.assert_allclose(_np(exact),
                               _np(tmm.matmul_plain(ta[:4], tw, **kw)), **F32)


@pytest.mark.parametrize("M", [1, 4, 17, 70])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_emulated_swiglu_vs_plain_and_pallas(M, norm):
    """The gated kernel's templates: both products share the splits and
    the row sums; bf16 output within a bf16 step of the plain function and
    of the Pallas kernel."""
    (ja, ta), (jg_, tg_), (ju, tu), (jg, tg), (jb, tb), (jr, tr) = \
        _inputs(20 + M, M)
    kw = _kwargs(norm, tg, tb, tr)
    got = tmm.gemm_emulate(ta, tg_, tu, plan=_plan(M, gated=True), **kw)
    plain = tmm.matmul_swiglu_plain(ta, tg_, tu, **kw)
    _close_bf16(got, plain)
    pallas = jmm.matmul_swiglu(ja, jg_, ju, block_m=16, block_n=16,
                               block_k=32, interpret=True,
                               **_kwargs(norm, jg, jb, jr))
    _close_bf16(got, pallas)
    if M <= tmm.STREAM_MAX_M:
        f32 = dict(kw, out_dtype=torch.float32)
        np.testing.assert_allclose(
            _np(tmm.gemm_emulate(ta, tg_, tu, plan=_plan(M, gated=True),
                                 **f32)),
            _np(tmm.matmul_swiglu_plain(ta, tg_, tu, **f32)), **F32)


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

def _served_shapes(cfg):
    """(K, N, gated) of the fused GEMMs a served path of `cfg` launches:
    the q / k / v / o projections of attention layers (core/attention.py;
    hybrid layers project with plain products), the MLP of every
    attention or hybrid layer (core/mlp.py) and the logits head
    (core/embedding.py)."""
    E = cfg.d_model
    kinds = {k for k, _ in cfg.schedule}
    shapes = {(E, cfg.padded_vocab, False)}
    if kinds & {"attn", "local"}:
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        shapes |= {(E, q, False), (E, kv, False), (q, E, False)}
    if kinds - {"ssm"}:
        shapes |= {(E, cfg.d_ff, cfg.mlp_act == "swiglu"),
                   (cfg.d_ff, E, False)}
    return sorted(shapes)


@pytest.mark.parametrize("cfg", SERVED, ids=lambda c: c.name)
def test_planner_covers_served_shapes(cfg):
    """Every served GEMM shape gets a plan: decode (M = 1..8) streams with
    K ranges covering [0, K) once, in a grid of at least two blocks per SM
    of 132 whatever the occupancy (2-4 blocks per SM); prefill (M = 9,
    512, 1100) runs the wgmma template, K split at 64-row steps only when
    its tiles cannot fill the card, into one wave."""
    for K_, N_, gated in _served_shapes(cfg):
        for M in (1, 4, 8):
            for bps in (2, 3, 4):
                plan = tmm.gemm_plan(M, K_, N_, gated=gated, blocks_per_sm=bps)
                assert plan.template == "stream"
                ranges = plan.k_ranges(K_)
                assert ranges[0][0] == 0 and ranges[-1][1] == K_
                assert all(k0 < k1 for k0, k1 in ranges)
                assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
                assert plan.grid == (-(-N_ // tmm.STREAM_COLS), len(ranges))
                assert plan.grid[0] * plan.grid[1] >= 2 * 132, (K_, N_, M)
        for M in (9, 512, 1100):
            plan = tmm.gemm_plan(M, K_, N_, gated=gated)
            assert plan.template == "wgmma"
            ranges = plan.k_ranges(K_)
            assert ranges[0][0] == 0 and ranges[-1][1] == K_
            assert all(a[1] == b[0] and a[1] % 64 == 0
                       for a, b in zip(ranges, ranges[1:]))
            assert plan.grid[0] * plan.grid[1] * plan.grid[2] <= 132 \
                or plan.splits == 1


def _pdot_shapes(cfg):
    """(K, N) of the plain products (`core/nn.py:pdot`) a served path of
    `cfg` launches on the card: the SSM projections (x, z, B|C, dt, out;
    widths padded to whole heads, core/ssm.py), the out-projection and
    the MLP of the unfused chain, and q / k / v of the hybrid layers."""
    from repro_torch.core.ssm import ssm_param_shapes
    E = cfg.d_model
    kinds = {k for k, _ in cfg.schedule}
    shapes = set()
    if cfg.has_ssm:
        shapes |= {s for name, s in ssm_param_shapes(cfg).items()
                   if name.startswith("w_")}
    if kinds - {"ssm"}:
        q, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        shapes |= {(E, q), (E, kv), (q, E), (cfg.d_ff, E)}
        if cfg.mlp_act != "swiglu":
            shapes.add((E, cfg.d_ff))
    return sorted(shapes)


@pytest.mark.parametrize("cfg", SERVED, ids=lambda c: c.name)
def test_planner_covers_served_pdot_shapes(cfg):
    """`pdot` on the card runs the hand GEMM with no prologue and no
    epilogue: every served plain product plans, stream at decode batch
    and wgmma at prefill lengths, none falls to another template."""
    shapes = _pdot_shapes(cfg)
    assert shapes
    for K_, N_ in shapes:
        assert K_ % 8 == 0 and N_ % 8 == 0, (K_, N_)
        for M in (1, 4, 8):
            assert tmm.gemm_plan(M, K_, N_).template == "stream"
        for M in (9, 96, 512, 1100):
            assert tmm.gemm_plan(M, K_, N_).template == "wgmma"


@pytest.mark.parametrize("out", ["act", "fp32"])
@pytest.mark.parametrize("policy", ["BF16", "FP32"])
def test_pdot_on_the_cpu_is_bit_equal_to_dot(policy, out):
    """The CPU (and the `ref` mode) keep the fp32 product `_dot`: the
    oracles do not move."""
    from repro_torch.core import precision
    from repro_torch.core.nn import act_dtype, pdot
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import _dot
    pol = getattr(precision, policy)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((3, 7, 64)),
                     dtype=torch.float32).to(pol.compute_dtype)
    w = torch.tensor(rng.standard_normal((64, 40)) * 0.1,
                     dtype=torch.float32).bfloat16()
    od = torch.float32 if out == "fp32" else None
    want = _dot(x.to(pol.compute_dtype), w.to(pol.compute_dtype),
                od or act_dtype(pol))
    for mode in ("auto", "ref"):
        with ops.kernel_mode(mode):
            got = pdot(x, w, pol, out_dtype=od)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("M", [4, 512])
def test_planner_refuses_unaligned_bf16_and_routes_fp32(M):
    with pytest.raises(ValueError, match="multiples of 8"):
        tmm.gemm_plan(M, 100, 64)
    with pytest.raises(ValueError, match="multiples of 8"):
        tmm.gemm_plan(M, 64, 100, gated=True)
    assert tmm.gemm_plan(M, 100, 100,
                         w_dtype=torch.float32).template == "fma32"


def test_wgmma_refuses_fp32_a_with_bf16_weights():
    """No hidden fallback: a bf16 weight with an fp32 A past the stream
    template is refused before any launch."""
    a = torch.zeros(16, 64)
    w = torch.zeros(64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma template"):
        tmm._launch_operands("fused_matmul", a, [w], [None, None, None],
                             None, 16, 32, torch.bfloat16, gated=False)

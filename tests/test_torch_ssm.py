"""PyTorch port, the Mamba2 SSD path and the residual norms, on the CPU:

  * `ssd_plain` (what the CUDA kernels of `csrc/ssd.cu` compute, stage by
    stage: chunk states, the scan over chunks, the outputs; and what the
    wrapper runs for CPU tensors) against the reference's sequential
    `ssd_ref`, its `ssd_chunked_ref`, and BOTH Pallas kernels in interpret
    mode (`ssd_multihead`, `ssd`) at S in {64, 128, 256}; at ragged S (137,
    and 5 < one chunk) against `ssd_ref`, y and h_final both, all at
    Bt = 2; the scan's state entering each chunk against `ssd_ref` run to
    that chunk's start;
  * `ssd_emulate` (the kernels' tensor-core operands: each fp32 operand
    split into bf16 hi + lo) against `ssd_plain` at the kernels' head dim,
    within the tolerances `chip_smoke.py` holds the kernels to;
  * `ops.ssd` dispatch (`ref` mode repeats the reference's chunk choice),
    `ssd_decode`, the conv steps and the gated RMSNorm with padded heads;
  * the residual norms' plain versions against the Pallas kernels in
    interpret mode, and `ops.residual_norm` against the reference's;
  * `ssm_full` / `ssm_decode` against `repro.core.ssm` at the reduced
    hymba and mamba2 configs (8 real SSM heads padded to 16).

Inputs come from a numpy seed and go to both frameworks.  Tolerances:
fp32 rtol = atol = 1e-4 — the two sides differ only in the order of fp32
sums (chunk length 64 against the reference's 128 or S, a scan against a
recurrence), a few ulps at these sizes; bf16 rtol = atol = 2e-2
(`tests/conftest.py`) — a bf16 ulp is 3.9e-3 of a value and the two sides
round their outputs once each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import ssm as jssm
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jnorm
from repro.kernels import ssd as jssd
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import ssm as tssm
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as tnorm
from repro_torch.kernels import ssd as tssd

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ssd_inputs(S, *, Bt=2, H=4, P=16, N=8, seed=0):
    """Numpy SSD operands as the block makes them: dt = softplus(.) > 0,
    A = -exp(.) < 0, B / C of unit scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)) - 2)).astype(
        np.float32)
    A = -np.exp(rng.uniform(0, 2, H)).astype(np.float32)
    B = rng.standard_normal((Bt, S, N)).astype(np.float32)
    C = rng.standard_normal((Bt, S, N)).astype(np.float32)
    D = rng.uniform(0.5, 1.5, H).astype(np.float32)
    return x, dt, A, B, C, D


def _both(arrs, dtype="f32"):
    """(jax, torch) operand tuples; x, B, C in `dtype`, the rest fp32."""
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    j, t = [], []
    for i, a in enumerate(arrs):
        low = i in (0, 3, 4)
        j.append(jnp.asarray(a).astype(jd if low else jnp.float32))
        t.append(torch.tensor(a).to(td if low else torch.float32))
    return j, t


# --------------------------------------------------------------------------
# SSD scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [64, 128, 256])
def test_ssd_plain_vs_oracles(S):
    j, t = _both(_ssd_inputs(S, seed=S))
    y, h = tssd.ssd_plain(*t)
    for want_y, want_h in (jref.ssd_ref(*j), jref.ssd_chunked_ref(*j)):
        np.testing.assert_allclose(_np(y), _np(want_y), **F32)
        np.testing.assert_allclose(_np(h), _np(want_h), **F32)
    assert h.dtype == torch.float32 and y.dtype == torch.float32


@pytest.mark.parametrize("S", [64, 128, 256])
@pytest.mark.parametrize("kernel", ["ssd_multihead", "ssd"])
def test_ssd_plain_vs_pallas(kernel, S):
    """Both TPU kernels (one function, split by a VMEM rule) at chunk 128:
    one chunk at S <= 128, two at 256."""
    j, t = _both(_ssd_inputs(S, seed=3 * S))
    want_y, want_h = getattr(jssd, kernel)(*j, chunk=128, interpret=True)
    y, h = tssd.ssd_plain(*t)
    np.testing.assert_allclose(_np(y), _np(want_y), **F32)
    np.testing.assert_allclose(_np(h), _np(want_h), **F32)


def test_ssd_plain_vs_pallas_bf16():
    j, t = _both(_ssd_inputs(128, seed=7), "bf16")
    want_y, want_h = jssd.ssd_multihead(*j, chunk=64, interpret=True)
    y, h = tssd.ssd_plain(*t)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(want_y), **BF16)
    np.testing.assert_allclose(_np(h), _np(want_h), **BF16)


@pytest.mark.parametrize("S", [137, 5])
def test_ssd_plain_ragged_vs_sequential(S):
    """A length the chunk does not divide: the tail chunk is padded with
    dt = 0, x = B = C = 0, which leaves y[:S] and h_final unchanged."""
    j, t = _both(_ssd_inputs(S, seed=S))
    want_y, want_h = jref.ssd_ref(*j)
    y, h = tssd.ssd_plain(*t)
    assert y.shape == t[0].shape
    np.testing.assert_allclose(_np(y), _np(want_y), **F32)
    np.testing.assert_allclose(_np(h), _np(want_h), **F32)


@pytest.mark.parametrize("S", [137, 256])
def test_ssd_scan_states_vs_sequential(S):
    """The scan stage alone: the state entering each chunk (and h_final)
    against the sequential recurrence run up to that chunk's start."""
    arrs = _ssd_inputs(S, seed=11 + S)
    _, t = _both(arrs)
    _, _, _, h_in, h = tssd.ssd_stages(*t[:5])
    L = tssd.CHUNK
    assert h_in.shape[1] == -(-S // L)
    np.testing.assert_array_equal(_np(h_in[:, 0]), 0)
    for c in range(1, h_in.shape[1]):
        j, _ = _both(tuple(a[:, :c * L] if a.ndim > 1 else a for a in arrs))
        np.testing.assert_allclose(_np(h_in[:, c]), _np(jref.ssd_ref(*j)[1]),
                                   **F32)
    np.testing.assert_allclose(_np(h), _np(jref.ssd_ref(*_both(arrs)[0])[1]),
                               **F32)


# the kernels' head dim; hymba's state width and mamba2's, few heads
@pytest.mark.parametrize("N", [16, 128])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ssd_emulate_vs_plain(dtype, N):
    """The kernels' split operands move y and h_final by ~2^-16 of a term:
    held to `ssd_plain` within chip_smoke.py's SSD tolerances (max|d| /
    max|plain|: y 1e-2 with bf16 operands — y itself is stored in bf16 —
    and 1e-3 with fp32 ones; h_final 1e-3)."""
    _, t = _both(_ssd_inputs(137, Bt=2, H=3, P=tssd.HEAD_DIM, N=N,
                             seed=N), dtype)
    y, h = tssd.ssd_plain(*t)
    ye, he = tssd.ssd_emulate(*t)
    y_tol = 1e-2 if dtype == "bf16" else 1e-3

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    assert ye.dtype == y.dtype and he.dtype == torch.float32
    assert rel(ye, y) <= y_tol and rel(he, h) <= 1e-3
    # the split is not a no-op: single bf16 parts would round x * w, the
    # decay-weighted G and the state at 2^-9
    assert 0 < rel(he, h) < 1e-4


def test_ref_ports_match_reference_oracles():
    j, t = _both(_ssd_inputs(96, seed=11))
    for fn, kw in ((tref.ssd_ref, {}), (tref.ssd_chunked_ref,
                                        {"chunk": 32})):
        jfn = getattr(jref, fn.__name__)
        for got, want in zip(fn(*t, **kw), jfn(*j, **kw)):
            np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_ssd_dispatch(mode):
    """`auto` on the CPU: the kernel wrapper's plain version, no launch;
    `ref`: the reference's own off-TPU dispatch, `ssd_chunked_ref` at the
    largest divisor of S <= 128 (S = 150 -> 75)."""
    x, dt, A, B, C, D = (torch.tensor(a) for a in _ssd_inputs(150, seed=5))
    before = tssd.ssd.launches
    with ops.kernel_mode(mode):
        y, h = ops.ssd(x, dt, A, B, C, D)
    assert tssd.ssd.launches == before
    want = (tssd.ssd_plain(x, dt, A, B, C, D) if mode == "auto"
            else tref.ssd_chunked_ref(x, dt, A, B, C, D, chunk=75))
    assert torch.equal(y, want[0]) and torch.equal(h, want[1])
    assert ops._best_chunk(150, 128) == 75 and ops._best_chunk(137, 128) == 1


def test_ssd_decode_matches_reference():
    rng = np.random.default_rng(12)
    Bt, H, P, N = 3, 4, 16, 8
    x, dt, A, B, C, D = _ssd_inputs(1, Bt=Bt, H=H, P=P, N=N, seed=12)
    h = rng.standard_normal((Bt, H, P, N)).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h)
    want = jops.ssd_decode(*(jnp.asarray(a) for a in args))
    got = ops.ssd_decode(*(torch.tensor(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_ssd_never_falls_back():
    """`cuda` mode refuses a CPU tensor; a tensor off the CPU with no kernel
    to launch raises — neither quietly runs the plain version."""
    shapes = [(1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 3), (1, 8, 3), (2,)]
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.ssd(*(torch.zeros(s) for s in shapes))
    with ops.kernel_mode("auto"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.ssd(*(torch.zeros(s, device="meta") for s in shapes))


# --------------------------------------------------------------------------
# residual norms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_residual_norm_plain_vs_pallas(kind, dtype):
    """[3, 7, 96] rows (21 rows against the kernel's 8-row blocks): h and
    the stored residual r."""
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((3, 7, 96)) * 2 + 0.5).astype(np.float32)
    y = rng.standard_normal((3, 7, 96)).astype(np.float32)
    g = (1 + 0.2 * rng.standard_normal(96)).astype(np.float32)
    b = (0.2 * rng.standard_normal(96)).astype(np.float32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    (jx, jy, jg, jb) = (jnp.asarray(a).astype(jd) for a in (x, y, g, b))
    (tx, ty, tg, tb) = (torch.tensor(a).to(td) for a in (x, y, g, b))
    tol = F32 if dtype == "f32" else BF16
    if kind == "rmsnorm":
        got = tnorm.residual_rmsnorm(tx, ty, tg)
        want = jnorm.residual_rmsnorm(jx, jy, jg, block_rows=8,
                                      interpret=True)
    else:
        got = tnorm.residual_layernorm(tx, ty, tg, tb)
        want = jnorm.residual_layernorm(jx, jy, jg, jb, block_rows=8,
                                        interpret=True)
    for g_, w_ in zip(got, want):
        assert g_.dtype == td and g_.shape == tx.shape
        np.testing.assert_allclose(_np(g_), _np(w_), **tol)
    # r is one rounding of the fp32 sum: exact against the kernel's
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


@pytest.mark.parametrize("mode", ["auto", "ref"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_ops_residual_norm_matches_reference_ops(kind, mode):
    rng = np.random.default_rng(23)
    x, y = (rng.standard_normal((5, 32)).astype(np.float32) for _ in "xy")
    p = {"scale": (1 + 0.1 * rng.standard_normal(32)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}
    want = jops.residual_norm(jnp.asarray(x), jnp.asarray(y),
                              {k: jnp.asarray(v) for k, v in p.items()},
                              kind)
    before = (tnorm.residual_rmsnorm.launches,
              tnorm.residual_layernorm.launches)
    with ops.kernel_mode(mode):
        got = ops.residual_norm(torch.tensor(x), torch.tensor(y),
                                {k: torch.tensor(v) for k, v in p.items()},
                                kind)
    assert (tnorm.residual_rmsnorm.launches,
            tnorm.residual_layernorm.launches) == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_residual_norm_never_falls_back(kind):
    p = {"scale": torch.zeros(8), "bias": torch.zeros(8)}
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.residual_norm(torch.zeros(2, 8), torch.zeros(2, 8), p, kind)
    meta = {k: v.to("meta") for k, v in p.items()}
    with ops.kernel_mode("auto"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.residual_norm(torch.zeros(2, 8, device="meta"),
                              torch.zeros(2, 8, device="meta"), meta, kind)


# --------------------------------------------------------------------------
# the SSM layer
# --------------------------------------------------------------------------

def test_conv_steps_match_reference():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tssm._causal_conv(torch.tensor(x), torch.tensor(w))),
        _np(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w))), **F32)
    got = tssm._conv_step(torch.tensor(x[:, 0]), torch.tensor(state),
                          torch.tensor(w))
    want = jssm._conv_step(jnp.asarray(x[:, 0]), jnp.asarray(state),
                           jnp.asarray(w))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w_), **F32)


def test_masked_rmsnorm_with_padded_heads():
    """Statistics over the real d_inner only: the pad columns carry large
    values that would move an unmasked norm, and come out zero."""
    rng = np.random.default_rng(31)
    real, dip = 40, 64
    y = rng.standard_normal((3, dip)).astype(np.float32)
    y[:, real:] *= 50
    z = rng.standard_normal((3, dip)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(dip)).astype(np.float32)
    got = tssm._masked_rmsnorm(torch.tensor(y), torch.tensor(z),
                               torch.tensor(scale), real)
    want = jssm._masked_rmsnorm(jnp.asarray(y), jnp.asarray(z),
                                jnp.asarray(scale), UNSHARDED, real)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert not _np(got)[:, real:].any()


@pytest.fixture(scope="module", params=["hymba-1.5b", "mamba2-2.7b"])
def ssm_layer(request):
    """One reduced SSM layer's reference weights (norm scale off 1, so the
    gated norm matters), converted through numpy."""
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    tree = jax.tree.map(np.asarray,
                        jssm.init_ssm(jax.random.key(3), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    tree["norm_scale"] = (1 + 0.1 * rng.standard_normal(
        tree["norm_scale"].shape)).astype(np.float32)
    assert tcfg.padded_ssm_heads() == 16 > tcfg.ssm_heads == 8
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            {k: torch.tensor(v) for k, v in tree.items()})


def test_ssm_full_matches_reference(ssm_layer):
    """S = 37 (not a multiple of any chunk) with the cache: the state and
    the last cw - 1 pre-conv inputs of both streams."""
    jcfg, tcfg, jp, tp = ssm_layer
    x = np.random.default_rng(32).standard_normal((2, 37, 64)).astype(
        np.float32)
    jy, jc = jssm.ssm_full(jp, jnp.asarray(x), plan=UNSHARDED, cfg=jcfg,
                           policy=JFP32, with_cache=True)
    ty, tc = tssm.ssm_full(tp, torch.tensor(x), cfg=tcfg, policy=FP32,
                           with_cache=True)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in ("h", "cx", "cbc"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **F32)


def test_ssm_decode_matches_reference(ssm_layer):
    jcfg, tcfg, jp, tp = ssm_layer
    rng = np.random.default_rng(33)
    Hp, P, N = 16, 16, 16
    cache = {"h": rng.standard_normal((3, Hp, P, N)).astype(np.float32),
             "cx": rng.standard_normal((3, 3, Hp * P)).astype(np.float32),
             "cbc": rng.standard_normal((3, 3, 2 * N)).astype(np.float32)}
    x = rng.standard_normal((3, 64)).astype(np.float32)
    jy, jc = jssm.ssm_decode(jp, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             plan=UNSHARDED, cfg=jcfg, policy=JFP32)
    ty, tc = tssm.ssm_decode(tp, torch.tensor(x),
                             {k: torch.tensor(v) for k, v in cache.items()},
                             cfg=tcfg, policy=FP32)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in ("h", "cx", "cbc"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **F32)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b"])
def test_init_ssm_draws_the_reference_layout(arch):
    """The port's own initializer: the reference's shapes, zero pad-head
    rows of w_out, dt = softplus(dt_bias) in [1e-3, 0.1], A in [-16, -1]."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    p = tssm.init_ssm(gen, cfg, torch.float32, "cpu")
    jshapes = jax.eval_shape(lambda: jssm.init_ssm(jax.random.key(0),
                                                   jax_config(arch).reduced(),
                                                   jnp.float32))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: v.shape for k, v in jshapes.items()}
    real = cfg.ssm_heads * cfg.ssm_head_dim
    assert not p["w_out"][real:].any() and p["w_out"][:real].abs().sum() > 0
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert (dt >= 1e-3 * 0.999).all() and (dt <= 0.1 * 1.001).all()
    A = -torch.exp(p["a_log"])
    assert (A <= -1.0 + 1e-6).all() and (A >= -16.0 - 1e-5).all()

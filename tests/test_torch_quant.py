"""PyTorch port, int8 serving, held to the JAX reference on the CPU at
reduced widths:

  * `quantize_int8_axiswise` and `quantize_params` bit-equal to the
    reference's (int8 q and fp32 scale) for gpt-j, gpt3-xl, phi4-mini,
    hymba and mamba2, the quantized leaves exactly `QUANT_KEYS` plus
    `unemb`; a quantized numpy tree converts with its q still int8;
  * the plain int8-weight GEMM and SwiGLU forms (and `gemm_emulate` at the
    stream and wgmma plans) against the Pallas `matmul` / `matmul_swiglu`
    in interpret mode with `b_scale` (full epilogue, RMSNorm and LayerNorm
    prologues), and the planner's int8 rules;
  * the plain int8-pool paged decode (partials at 1-3 splits, the
    normalized route) and the oracles against the Pallas kernels in
    interpret mode with `k_scale` / `v_scale`, over ragged lengths and
    absent entries;
  * quantize-on-write (`_append_quantized`) and the quantizing
    `prefill_scatter` bit-equal to the reference's pools and scales,
    including blocks reused after a free;
  * teacher-forced prefill + decode with the reference's own quantized
    weights within fp32 1e-4 of the reference's residuals and logits, and
    with int8 KV as well;
  * the engine with both knobs (no leaks, the dtypes, the byte ratios),
    the int8 decode step bit-equal to the eager step and free of host
    data, and the int8 forms never falling back off the CPU.

Tolerances: fp32 rtol = atol = 1e-4 (`tests/conftest.py`), bf16 2e-2,
unless a test says otherwise.  Free-running tokens are never compared
across frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as jattn
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
from repro.kernels import flash_decode as jfd
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models.quantize import QUANT_KEYS as JQUANT_KEYS
from repro.models.quantize import quantize_params as jquantize_params
from repro.optim.compression import quantize_int8_axiswise as jquant
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import attention as tattn
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models.quantize import QUANT_KEYS, quantize_params
from repro_torch.optim.compression import quantize_int8_axiswise
from repro_torch.serving import InferenceEngine, Request, SamplingParams
from repro_torch.serving.kv_cache import prefill_scatter
from repro_torch.serving.sampling import device_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["gpt-j", "gpt3-xl", "phi4-mini-3.8b", "hymba-1.5b", "mamba2-2.7b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x, dtype=None):
    """numpy -> torch, keeping int8 / int32 as they are."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _qleaves(tree, path=""):
    """{path: {"q", "scale"}} of a parameter tree (either framework)."""
    out = {}
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            return {path: tree}
        for k, v in tree.items():
            out.update(_qleaves(v, f"{path}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_qleaves(v, f"{path}[{i}]"))
    return out


def _leaf_names(tree, path=""):
    """{path: (name, ndim)} of every array leaf (quantized leaves once)."""
    out = {}
    if isinstance(tree, dict) and set(tree) != {"q", "scale"}:
        for k, v in tree.items():
            out.update(_leaf_names(v, f"{path}/{k}"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_leaf_names(v, f"{path}[{i}]"))
    else:
        leaf = tree["q"] if isinstance(tree, dict) else tree
        out[path] = (path.rsplit("/", 1)[-1], leaf.ndim)
    return out


# --------------------------------------------------------------------------
# quantization: the rule and the parameter tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, (1,), (0, 2), 2])
def test_quantize_int8_axiswise_bit_equal(axis):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 7)) * 0.3).astype(np.float32)
    x[2] = 0.0                                       # a zero slice: amax floor
    x[0, 0, :3] = [0.5, -0.5, 1.5]                   # ties of round-half-even
    q, s = quantize_int8_axiswise(torch.tensor(x), axis=axis)
    jq, js = jquant(jnp.asarray(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_bit_equal_to_reference(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jlm.init_lm(jax.random.key(3), jcfg, jnp.bfloat16)
    tp = tlm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               dtype=torch.bfloat16, device="cpu")
    got, want = _qleaves(quantize_params(tp)), _qleaves(jquantize_params(jp))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path]["q"].dtype == torch.int8
        assert got[path]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got[path]["q"].numpy(),
                                      np.asarray(leaf["q"]))
        np.testing.assert_array_equal(got[path]["scale"].numpy(),
                                      np.asarray(leaf["scale"]))
    # coverage: every rank-3 QUANT_KEYS leaf and the head, nothing else
    names = _leaf_names(tp)
    expect = {p for p, (n, nd) in names.items()
              if (n in QUANT_KEYS and nd == 3) or p == "/embedding/unemb"}
    assert set(got) == expect and "/embedding/unemb" in got
    assert QUANT_KEYS == JQUANT_KEYS


def test_quantized_tree_converts_with_int8_leaves():
    """A quantized reference tree through `params_from_numpy`: q stays
    int8 (never cast through float32), scales fp32, both bit-equal; a bad
    quantized leaf raises."""
    jcfg, tcfg = jax_config("phi4-mini-3.8b").reduced(), \
        get_config("phi4-mini-3.8b").reduced()
    jq = jquantize_params(jlm.init_lm(jax.random.key(1), jcfg, jnp.float32))
    tree = jax.tree.map(np.asarray, jq)
    tp = tlm.params_from_numpy(tree, tcfg, device="cpu")
    want, got = _qleaves(jq), _qleaves(tp)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[path]["q"].numpy(),
                                      np.asarray(leaf["q"]))
        np.testing.assert_array_equal(got[path]["scale"].numpy(),
                                      np.asarray(leaf["scale"]))
    tree["embedding"]["unemb"]["q"] = tree["embedding"]["unemb"]["q"].astype(
        np.float32)
    with pytest.raises(ValueError, match="unemb"):
        tlm.params_from_numpy(tree, tcfg, device="cpu")


# --------------------------------------------------------------------------
# the int8-weight GEMM forms
# --------------------------------------------------------------------------

def _qweight(rng, K, N):
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    q, s = jquant(jnp.asarray(w), axis=(1,))
    return np.asarray(q), np.asarray(s)


def _gemm_inputs(seed, M=24, K=64, N=48, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, K)).astype(dtype)
    q, s = _qweight(rng, K, N)
    g = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    return a, q, s, g, b, bias, res


def _norm_kw(norm, g, b, conv):
    kw = {"norm": norm}
    if norm != "none":
        kw["gamma"] = conv(g)
    if norm == "layernorm":
        kw["nbeta"] = conv(b)
    return kw


@pytest.mark.parametrize("epilogue", ["none", "full"])
@pytest.mark.parametrize("norm", ["none", "rmsnorm", "layernorm"])
def test_int8_matmul_plain_vs_pallas(norm, epilogue):
    """matmul_plain with an int8 B and its column scales against the TPU
    kernel in interpret mode (bias, i_gelu and residual for `full`):
    fp32 1e-4 — the two differ by the order of fp32 sums only."""
    a, q, s, g, b, bias, res = _gemm_inputs(1)
    ep = dict(bias=bias, residual=res, activation="i_gelu") \
        if epilogue == "full" else {}
    want = jmm.matmul(jnp.asarray(a), jnp.asarray(q), b_scale=jnp.asarray(s),
                      block_m=8, block_n=16, block_k=32, interpret=True,
                      **_norm_kw(norm, g, b, jnp.asarray),
                      **{k: jnp.asarray(v) if not isinstance(v, str) else v
                         for k, v in ep.items()})
    got = tmm.matmul_plain(torch.tensor(a), _t(q), b_scale=_t(s),
                           **_norm_kw(norm, g, b, torch.tensor),
                           **{k: torch.tensor(v) if not isinstance(v, str)
                              else v for k, v in ep.items()})
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("template,M", [("stream", 4), ("wgmma", 24)])
def test_int8_gemm_emulate_vs_pallas(template, M, norm):
    """The int8 templates' arithmetic (`gemm_emulate` at the planner's
    split of K; wgmma: x * gamma rounded to bf16) against the TPU kernel
    on a bf16 A: bf16 2e-2 (the bf16 output's rounding)."""
    a, q, s, g, b, _, res = _gemm_inputs(2, M=M, K=256, N=32)
    a16 = torch.tensor(a).bfloat16()
    plan = tmm.gemm_plan(M, 256, 32, w_dtype=torch.int8, kchunk=64)
    assert plan.template == template and plan.splits == 4
    want = jmm.matmul(jnp.asarray(a16.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(q), b_scale=jnp.asarray(s),
                      residual=jnp.asarray(res), interpret=True,
                      block_m=8, block_n=16, block_k=64,
                      **_norm_kw(norm, g, b, jnp.asarray))
    got = tmm.gemm_emulate(a16, _t(q), plan=plan, scales=[_t(s)],
                           residual=torch.tensor(res),
                           **_norm_kw(norm, g, b, torch.tensor))
    plain = tmm.matmul_plain(a16, _t(q), b_scale=_t(s),
                             residual=torch.tensor(res),
                             **_norm_kw(norm, g, b, torch.tensor))
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    np.testing.assert_allclose(_np(got), _np(plain), **BF16)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("norm", ["none", "rmsnorm", "layernorm"])
def test_int8_swiglu_plain_vs_pallas(norm, residual):
    rng = np.random.default_rng(3)
    M, K, N = 16, 64, 40
    a = rng.standard_normal((M, K)).astype(np.float32)
    qg, sg = _qweight(rng, K, N)
    qu, su = _qweight(rng, K, N)
    g = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    want = jmm.matmul_swiglu(
        jnp.asarray(a), jnp.asarray(qg), jnp.asarray(qu),
        bg_scale=jnp.asarray(sg), bu_scale=jnp.asarray(su),
        residual=jnp.asarray(res) if residual else None, block_m=8,
        block_n=8, block_k=32, interpret=True,
        **_norm_kw(norm, g, b, jnp.asarray))
    got = tmm.matmul_swiglu_plain(
        torch.tensor(a), _t(qg), _t(qu), bg_scale=_t(sg), bu_scale=_t(su),
        residual=torch.tensor(res) if residual else None,
        **_norm_kw(norm, g, b, torch.tensor))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_ops_int8_entry_points_match_reference_ops(mode):
    """The ops layer's int8 dicts (pdot, matmul, matmul_swiglu,
    fused_matmul, fused_matmul_swiglu) against the reference's ops on its
    CPU path (the reference's unfused order: a dot at the output dtype,
    then the scale): fp32 1e-4."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    q1, s1 = _qweight(rng, 32, 24)
    q2, s2 = _qweight(rng, 32, 24)
    g = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jw = [{"q": jnp.asarray(q), "scale": jnp.asarray(s)}
          for q, s in ((q1, s1), (q2, s2))]
    tw = [{"q": _t(q), "scale": _t(s)} for q, s in ((q1, s1), (q2, s2))]
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jpro = jops.norm_prologue({"scale": jnp.asarray(g)}, "rmsnorm")
    tpro = ops.norm_prologue({"scale": torch.tensor(g)}, "rmsnorm")
    from repro.core.nn import pdot as jpdot
    from repro_torch.core.nn import pdot as tpdot
    want = [jpdot(jx, jw[0], JFP32),
            jops.matmul(jx, jw[0], activation="gelu"),
            jops.matmul_swiglu(jx, jw[0], jw[1]),
            jops.fused_matmul(jx, jw[0], prologue=jpro,
                              compute_dtype=jnp.float32),
            jops.fused_matmul_swiglu(jx, jw[0], jw[1], prologue=jpro,
                                     compute_dtype=jnp.float32)]
    with ops.kernel_mode(mode):
        got = [tpdot(tx, tw[0], FP32),
               ops.matmul(tx, tw[0], activation="gelu"),
               ops.matmul_swiglu(tx, tw[0], tw[1]),
               ops.fused_matmul(tx, tw[0], prologue=tpro,
                                compute_dtype=torch.float32),
               ops.fused_matmul_swiglu(tx, tw[0], tw[1], prologue=tpro,
                                       compute_dtype=torch.float32)]
    for w, t in zip(want, got):
        np.testing.assert_allclose(_np(t), _np(w), **F32)


def test_ops_int8_modes_agree():
    """`auto` (the kernels' plain forms on the CPU) and `ref` (the oracle)
    give the same int8 products within fp32 1e-4."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((3, 32)).astype(np.float32))
    q, s = _qweight(rng, 32, 16)
    w = {"q": _t(q), "scale": _t(s)}
    pro = ops.norm_prologue({"scale": torch.ones(32),
                             "bias": torch.zeros(32)}, "layernorm")
    out = {}
    for mode in ("auto", "ref"):
        with ops.kernel_mode(mode):
            out[mode] = [ops.pdot(x, w, compute_dtype=torch.float32,
                                  out_dtype=torch.float32),
                         ops.fused_matmul(x, w, prologue=pro,
                                          compute_dtype=torch.float32)]
    for a, b in zip(out["auto"], out["ref"]):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


def test_int8_gemm_plan_rules():
    """int8 weights take the stream template at M <= 8 and wgmma above,
    never fma32; the wgmma template needs N % 16 == 0 (TMA reads 16-byte
    int8 rows); every served int8 width is taken."""
    served = {"gpt-j": (4096, 16384, 50432),
              "phi4-mini-3.8b": (3072, 1024, 8192, 200192)}
    for arch, widths in served.items():
        for N in widths:
            for M in (1, 4, 8, 9, 512):
                plan = tmm.gemm_plan(M, 3072, N, w_dtype=torch.int8)
                assert plan.template == ("stream" if M <= 8 else "wgmma")
    assert tmm.gemm_plan(4, 64, 24, w_dtype=torch.int8).template == "stream"
    with pytest.raises(ValueError, match="N % 16"):
        tmm.gemm_plan(16, 64, 24, w_dtype=torch.int8)
    with pytest.raises(TypeError):
        tmm.gemm_plan(4, 64, 32, w_dtype=torch.float16)


# --------------------------------------------------------------------------
# the int8-pool paged decode
# --------------------------------------------------------------------------

def _int8_pool(rng, NB, BS, KV, D):
    x = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    q, s = jquant(jnp.asarray(x), axis=(0, 2))
    return np.asarray(q), np.asarray(s)


def _paged_int8(B, H, KV, D, seed=0, NB=6, BS=8, MB=3):
    rng = np.random.default_rng(seed)
    kq, ks = _int8_pool(rng, NB, BS, KV, D)
    vq, vs = _int8_pool(rng, NB, BS, KV, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = np.stack([rng.permutation(NB)[:MB] for _ in range(B)]).astype(
        np.int32)
    tables[-1, -1] = -1                                   # an absent entry
    lengths = np.array([BS * MB, 5, 17, 9][:B], np.int32)
    return q, kq, ks, vq, vs, tables, lengths


@pytest.mark.parametrize("B,H,KV,D", [(2, 4, 4, 32), (3, 8, 2, 16),
                                      (4, 8, 2, 16)])
def test_int8_paged_attention_vs_pallas(B, H, KV, D):
    """The normalized route (the split count `paged_splits` picks, merged)
    and the port's oracle against the TPU kernel in interpret mode and the
    reference's oracle: fp32 1e-4."""
    q, kq, ks, vq, vs, tab, ln = _paged_int8(B, H, KV, D)
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(tab), jnp.asarray(ln))
    want = jfd.paged_decode_attention(*jargs, k_scale=jnp.asarray(ks),
                                      v_scale=jnp.asarray(vs), interpret=True)
    targs = (torch.tensor(q), _t(kq), _t(vq), _t(tab), _t(ln))
    sc = dict(k_scale=_t(ks), v_scale=_t(vs))
    got = tfd.paged_decode_attention(*targs, **sc)
    oracle = tref.paged_decode_attention_ref(*targs, **sc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(oracle), _np(want), **F32)
    np.testing.assert_allclose(
        _np(oracle), _np(jref.paged_decode_attention_ref(
            *jargs, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))), **F32)


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_int8_paged_partials_vs_pallas(splits):
    """The plain int8 partials at `splits` ranges of the table: each
    range's (o, m, l) against the TPU partials kernel in interpret mode
    with the entries outside the range absent, over ragged lengths and
    absent entries (the reference test's tables).  m, l fp32 1e-4; o
    fp32 2e-4 absolute, as the reference's own test holds its kernel."""
    rng = np.random.default_rng(2)
    B, H, KV, D, NB, BS = 2, 4, 4, 32, 6, 8
    kq, ks = _int8_pool(rng, NB, BS, KV, D)
    vq, vs = _int8_pool(rng, NB, BS, KV, D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tab = np.array([[0, 2, -1], [5, -1, -1]], np.int32)
    ln = np.array([11, 8], np.int32)
    o, m, l = tfd.paged_decode_plain(torch.tensor(q), _t(kq), _t(vq), _t(tab),
                                     _t(ln), splits, k_scale=_t(ks),
                                     v_scale=_t(vs))
    if splits == 1:
        o, m, l = o[None], m[None], l[None]
    for z, (e0, e1) in enumerate(tfd.split_ranges(tab.shape[1], splits)):
        sub = np.where((np.arange(3) >= e0) & (np.arange(3) < e1), tab, -1)
        jo, jm, jl = jfd.paged_decode_partials(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(sub.astype(np.int32)), jnp.asarray(ln),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True)
        live = _np(l[z]) > 0
        np.testing.assert_array_equal(live, np.asarray(jl) > 0)
        np.testing.assert_allclose(_np(m[z])[live], np.asarray(jm)[live],
                                   **F32)
        np.testing.assert_allclose(_np(l[z]), np.asarray(jl), **F32)
        np.testing.assert_allclose(_np(o[z]), np.asarray(jo), rtol=2e-5,
                                   atol=2e-4)


def test_int8_pool_attention_within_quantization_error():
    """The int8 pool's output sits within quantization error of attending
    over the unquantized pool (the reference test's bound, 0.05)."""
    rng = np.random.default_rng(1)
    B, H, KV, D, NB, BS = 2, 4, 4, 32, 4, 8
    k = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, KV, D)).astype(np.float32)
    kq, ks = quantize_int8_axiswise(torch.tensor(k), axis=(0, 2))
    vq, vs = quantize_int8_axiswise(torch.tensor(v), axis=(0, 2))
    q = torch.tensor(rng.standard_normal((B, H, D)).astype(np.float32))
    tab = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ln = torch.tensor([16, 13], dtype=torch.int32)
    exact = tfd.paged_decode_attention(q, torch.tensor(k), torch.tensor(v),
                                       tab, ln)
    quant = tfd.paged_decode_attention(q, kq, vq, tab, ln, k_scale=ks,
                                       v_scale=vs)
    assert float((exact - quant).abs().max()) < 0.05


# --------------------------------------------------------------------------
# quantize-on-write: decode append and admission
# --------------------------------------------------------------------------

def test_append_quantized_bit_equal_with_block_reuse():
    """Eight decode appends of 3 rows into an int8 pool against the
    reference's `_append_quantized`: fresh blocks (offset 0) set their
    scale, later offsets clip against it, a row that owns no block writes
    nothing the reference keeps, and a block freed and handed to another
    row restarts at offset 0 over its stale scale.  Pools and scales
    bit-equal (the port's sink row aside) to the reference's function
    jitted, as its decode step runs it."""
    rng = np.random.default_rng(7)
    NB, BS, KV, hd, B = 5, 4, 2, 8, 3
    jpool = jnp.zeros((NB, BS, KV, hd), jnp.int8)
    jsc = jnp.zeros((NB, KV), jnp.float32)
    tpool = torch.zeros((NB + 1, BS, KV, hd), dtype=torch.int8)
    tsc = torch.zeros((NB + 1, KV), dtype=torch.float32)
    # (block, offset) of each row per step; -1: the row owns no block.
    # Block 1 is row 0's, then row 2 takes it over at step 5 (a reuse).
    plan = [((1, 0), (3, 0), (-1, 0)), ((1, 1), (3, 1), (-1, 1)),
            ((1, 2), (3, 2), (0, 0)), ((1, 3), (3, 3), (0, 1)),
            ((4, 0), (2, 0), (0, 2)), ((4, 1), (2, 1), (1, 0)),
            ((4, 2), (2, 2), (1, 1)), ((4, 3), (2, 3), (1, 2))]
    for step in plan:
        x = (rng.standard_normal((B, KV, hd)) * (1 + rng.random())).astype(
            np.float32)
        blk = np.array([b for b, _ in step], np.int32)
        off = np.array([o for _, o in step], np.int32)
        loc = np.where(blk >= 0, blk, NB)
        jpool, jsc = jax.jit(jattn._append_quantized)(
            jpool, jsc, jnp.asarray(x), jnp.asarray(loc), jnp.asarray(off))
        owned = torch.tensor(blk >= 0)
        tattn._append_quantized((tpool,), (tsc,), (torch.tensor(x),),
                                torch.tensor(np.where(blk >= 0, blk, NB),
                                             dtype=torch.int64),
                                torch.tensor(off, dtype=torch.int64), owned)
        np.testing.assert_array_equal(tpool[:NB].numpy(), np.asarray(jpool))
        np.testing.assert_array_equal(tsc[:NB].numpy(), np.asarray(jsc))


def test_prefill_scatter_quantizes_like_the_reference():
    """Admission of a 2-row group (13 and 6 tokens, 4-token blocks; the
    bucket's pad rows are the group cache's own) into int8 pools that hold
    stale blocks and scales: pools and scales bit-equal to the reference's
    quantizing scatter; a second group into blocks the first one freed."""
    rng = np.random.default_rng(8)
    count, NB, BS, KV, hd, MB = 2, 8, 4, 2, 8, 4
    stale = rng.integers(-127, 128, (count, NB, BS, KV, hd)).astype(np.int8)
    stale_s = rng.random((count, NB, KV)).astype(np.float32)
    jc = ({"k": jnp.asarray(stale), "v": jnp.asarray(stale),
           "ks": jnp.asarray(stale_s), "vs": jnp.asarray(stale_s)},)
    pad = ((0, 0), (0, 1), (0, 0), (0, 0), (0, 0))
    tc = ({"k": torch.tensor(np.pad(stale, pad)),
           "v": torch.tensor(np.pad(stale, pad)),
           "ks": torch.tensor(np.pad(stale_s, pad[:3])),
           "vs": torch.tensor(np.pad(stale_s, pad[:3]))},)
    scatter = make_prefill_scatter((True,), BS)
    for tables in (np.array([[3, 6, 1, 7], [0, 4, -1, -1]], np.int32),
                   np.array([[6, 3, -1, -1], [1, 2, 5, -1]], np.int32)):
        S = 13
        group = {k: (rng.standard_normal((count, 2, S, KV, hd)) * 2).astype(
            np.float32) for k in ("k", "v")}
        jgroup = ({k: jnp.asarray(v).astype(jnp.bfloat16)
                   for k, v in group.items()},)
        tgroup = ({k: torch.tensor(v).bfloat16() for k, v in group.items()},)
        jc = scatter(jc, jgroup, jnp.arange(2, dtype=jnp.int32),
                     jnp.asarray(tables))
        prefill_scatter(tc, tgroup, torch.arange(2), torch.tensor(tables),
                        block_size=BS)
        for key in ("k", "v", "ks", "vs"):
            np.testing.assert_array_equal(tc[0][key][:, :NB].numpy(),
                                          np.asarray(jc[0][key]))


# --------------------------------------------------------------------------
# model level: teacher-forced prefill and decode with int8 weights and KV
# --------------------------------------------------------------------------

def _quant_models(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jquantize_params(jlm.init_lm(jax.random.key(7), jcfg, jnp.float32))
    tp = tlm.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    return jcfg, tcfg, jp, tp


def _logits(jcfg, tcfg, jp, tp, jx, tx):
    B, S, E = jx.shape
    jz, _ = jemb.logits_local(
        jx.reshape(B * S, E), jp["embedding"]["unemb"], plan=UNSHARDED,
        cfg=jcfg, policy=JFP32,
        norm=jops.norm_prologue(jp["final_norm"], jcfg.norm))
    tz = temb.logits_local(
        tx.reshape(B * S, E), tp["embedding"]["unemb"], cfg=tcfg,
        policy=FP32, norm=ops.norm_prologue(tp["final_norm"], tcfg.norm))
    return _np(tz), _np(jz)


# int8 KV: the pools are held entry for entry (their scales are bit-equal,
# `test_prefill_scatter_quantizes_like_the_reference`), so the decode
# logits keep the fp32 tolerance.  One entry one quantization step apart
# would move an attention output by up to its block's V scale (amax / 127,
# ~1e-2 of the values here) times that position's weight, far past 1e-4:
# the count of differing entries is asserted on its own (0).


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_teacher_forced_int8_weights(arch, kv):
    """The reference's own quantized weights: prefill residuals and
    logits at every position, then 3 teacher-forced decode steps over the
    paged pools (int8 pools with `kv="int8"`), against the reference's
    `_run_segments_prefill` / `_run_segments_decode`: fp32 1e-4, int8 KV
    included (see above).  Each decode step starts from the
    reference's pools, as `test_torch_lm` does, and the int8 pool entries
    that differ from the reference's after each step are counted (0 on
    these inputs)."""
    jcfg, tcfg, jp, tp = _quant_models(arch)
    rng = np.random.default_rng(5)
    B, S, BS, n_dec, NB = 2, 13, 8, 3, 10
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    jx = jlm._embed_sequence(jp, {"tokens": jnp.asarray(tokens[:, :S])},
                             plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=UNSHARDED, cfg=jcfg, policy=JFP32, max_seq=32,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(tokens[:, :S]), policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=32, compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(*_logits(jcfg, tcfg, jp, tp, jx, tx), **F32)

    # both pools from the reference's bf16 compact caches (its prefill
    # cache dtype): the admission scatter is held bit for bit above
    layout = tsteps.make_paged_layout(tcfg, 32, num_blocks=NB, block_size=BS)
    int8 = kv == "int8"
    tpools = tsteps.cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                                 device="cpu", kv_dtype=kv)
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    tables[0, :3] = [4, 1, 8]
    tables[1, :3] = [0, 9, 2]
    count = jcfg.n_layers
    shape = (count, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
    jpools = {"k": jnp.zeros(shape, jnp.int8 if int8 else jnp.float32),
              "v": jnp.zeros(shape, jnp.int8 if int8 else jnp.float32)}
    if int8:
        jpools["ks"] = jnp.zeros(shape[:2] + shape[3:4], jnp.float32)
        jpools["vs"] = jnp.zeros(shape[:2] + shape[3:4], jnp.float32)
    jpools = make_prefill_scatter((True,), BS)(
        (jpools,), jcaches, jnp.arange(B, dtype=jnp.int32),
        jnp.asarray(tables))
    prefill_scatter(tpools, tuple({k: torch.tensor(np.asarray(v, np.float32))
                                   for k, v in seg.items()}
                                  for seg in jcaches),
                    torch.arange(B), torch.tensor(tables), block_size=BS)
    keys = ("k", "v", "ks", "vs") if int8 else ("k", "v")
    for key in keys:
        np.testing.assert_array_equal(tpools[0][key][:, :NB].numpy(),
                                      np.asarray(jpools[0][key]))

    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    differ = 0
    for i in range(n_dec):
        for key in keys:
            tpools[0][key][:, :NB] = torch.tensor(np.asarray(jpools[0][key]))
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=UNSHARDED, policy=JFP32)
        jxd, jpools = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jpools, plan=UNSHARDED, cfg=jcfg,
            policy=JFP32, memory_len=0, block_tables=jtab,
            paged_segments=(True,))
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tpools = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tpools, cfg=tcfg, policy=FP32,
            block_tables=ttab)
        np.testing.assert_allclose(_np(txd), _np(jxd), **F32)
        np.testing.assert_allclose(
            *_logits(jcfg, tcfg, jp, tp, jxd[:, None], txd[:, None]),
            **F32)
        if int8:
            for key in ("k", "v"):
                differ += int((tpools[0][key][:, :NB].numpy()
                               != np.asarray(jpools[0][key])).sum())
            for key in ("ks", "vs"):
                np.testing.assert_allclose(tpools[0][key][:, :NB].numpy(),
                                           np.asarray(jpools[0][key]), **F32)
        else:
            for key in keys:
                np.testing.assert_allclose(tpools[0][key][:, :NB].numpy(),
                                           np.asarray(jpools[0][key]), **F32)
    assert differ == 0, f"{differ} int8 pool entries differ"


# --------------------------------------------------------------------------
# the engine and the decode step
# --------------------------------------------------------------------------

def _trace(cfg, n=4, max_new=6, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 9 + 5 * i,
                                               dtype=np.int32),
                    max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.8, top_k=8,
                                            seed=2**31 - 1 - i)
                    if i % 2 else SamplingParams()) for i in range(n)]


def _run(cfg, params, **kw):
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                          policy=FP32, block_size=8, device="cpu", **kw)
    for r in _trace(cfg):
        eng.submit(r)
    done = {t.uid: t.output for t in eng.run()}
    return eng, done


@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_engine_both_knobs(arch):
    """Both knobs through the engine: every request completes, no block
    leaks, the stats report the dtypes and the byte shrink (the reference
    test's ratios: weights < 0.62x, KV pool < 0.55x of the unquantized
    engine's), and the summary shows the QUANT part."""
    cfg = get_config(arch).reduced()
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=0)
    base_eng, base = _run(cfg, params)
    eng, done = _run(cfg, params, weight_dtype="int8", kv_dtype="int8")
    assert sorted(done) == sorted(base)
    assert all(len(done[u]) == len(base[u]) == 6 for u in base)
    st, bst = eng.stats(), base_eng.stats()
    assert (st.weight_dtype, st.kv_dtype) == ("int8", "int8")
    assert (bst.weight_dtype, bst.kv_dtype) == ("bfloat16", "bfloat16")
    assert 0 < st.weight_bytes_per_device < 0.62 * bst.weight_bytes_per_device
    assert 0 < st.kv_pool_bytes < 0.55 * bst.kv_pool_bytes
    assert "QUANT" in st.summary() and "QUANT" not in bst.summary()
    assert st.to_dict()["kv_dtype"] == "int8"
    assert eng.allocator.num_free == eng.allocator.num_blocks
    pools = [leaf for seg in eng.runner.caches for k, leaf in seg.items()
             if k in ("k", "v")]
    assert pools and all(p.dtype == torch.int8 for p in pools)


def test_engine_int8_kv_with_block_reuse():
    """An int8-KV engine whose pool is too small for its batch: requests
    (7-token prompts, 12 new tokens, 3 blocks each at the end) are
    preempted, blocks are freed and handed out again mid-run (their stale
    scales replaced by admission or the first append), and every request
    completes with no leak, as with a pool that never preempts."""
    cfg = get_config("gpt-j").reduced()
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=2)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, 7, dtype=np.int32)
               for _ in range(4)]
    runs = {}
    for blocks in (4, None):
        eng = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                              policy=FP32, block_size=8, device="cpu",
                              kv_dtype="int8", kv_pool_blocks=blocks)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
        runs[blocks] = (eng, {t.uid: t.output for t in eng.run()})
    small, done_small = runs[4]
    big, done_big = runs[None]
    assert small.stats().preemptions > 0 and big.stats().preemptions == 0
    assert sorted(done_small) == sorted(done_big) == [0, 1, 2, 3]
    assert all(len(v) == 12 for v in done_small.values())
    assert small.allocator.num_free == small.allocator.num_blocks
    assert small.allocator.peak_used == small.allocator.num_blocks


def _int8_step_setup(arch, seed=0):
    cfg = get_config(arch).reduced()
    params = quantize_params(tlm.init_lm(cfg, dtype=torch.float32,
                                         device="cpu", seed=seed))
    rng = np.random.default_rng(seed)
    B, BS, max_seq = 4, 4, 32
    layout = tsteps.make_paged_layout(cfg, max_seq, B * (max_seq // BS), BS)
    caches = tsteps.cache_layout(cfg, layout, batch_size=B, policy=FP32,
                                 device="cpu", kv_dtype="int8")
    for seg in caches:
        for key, leaf in seg.items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.from_numpy(rng.integers(
                    -127, 128, tuple(leaf.shape)).astype(np.int8)))
            else:
                leaf.copy_(torch.from_numpy(rng.random(
                    tuple(leaf.shape)).astype(np.float32) * 0.05))
    tables = rng.permutation(layout.num_blocks).reshape(
        B, layout.max_blocks).astype(np.int32)
    tables[3] = -1                                        # a free slot
    pos = np.array([3, 4, 9, 0], np.int32)                # offsets 3, 0, 1
    tokens = rng.integers(0, cfg.vocab, B).astype(np.int32)
    lane = {"temperature": np.array([0.0, 0.8, 1.2, 0.0], np.float32),
            "top_k": np.array([0, 40, 0, 5], np.int32),
            "seed": np.array([3, 101, 2**31 - 7, 9], np.int32)}
    return cfg, params, layout, caches, tables, pos, tokens, lane


@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_int8_decode_step_bit_equal_to_eager(arch):
    """The int8 runner's decode step (int8 weights and pools, the static
    buffers) against the eager `forward_decode` over 5 steps: tokens,
    pools and scales bit-equal, across block starts (fresh scales) and a
    slot with no block (its writes go to the sink)."""
    cfg, params, layout, caches, tables, pos, tokens, lane = \
        _int8_step_setup(arch)
    eager = tuple({k: v.clone() for k, v in seg.items()} for seg in caches)
    step = tsteps.make_decode_step(cfg, params, caches, policy=FP32,
                                   layout=layout, batch_size=4, device="cpu")
    tok_e, pos_e = torch.tensor(tokens), torch.tensor(pos)
    tok_s, pos_s = tokens.copy(), pos.copy()
    for _ in range(5):
        got, got_pos, _ = step.fn(tok_s, pos_s, tables, lane)
        want, _ = tlm.forward_decode(
            params, tok_e, pos_e, eager, cfg=cfg, policy=FP32,
            block_tables=torch.tensor(tables), lane=device_lane(lane, "cpu"),
            paged_segments=layout.segments)
        assert torch.equal(got, want.to(torch.int32))
        for seg_s, seg_e in zip(caches, eager):
            assert set(seg_s) >= {"k", "v", "ks", "vs"}
            for k in seg_s:
                assert torch.equal(seg_s[k], seg_e[k]), k
        tok_s, pos_s = got.numpy().copy(), pos_s + 1
        tok_e, pos_e = want, pos_e + 1


@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_int8_decode_step_makes_no_tensor_from_host_data(arch, monkeypatch):
    """The int8 runners' step (quantize-on-write included) makes no tensor
    from host data: `torch.tensor`, `as_tensor` and `from_numpy` raise
    while it runs (the CPU's proxy for a CUDA graph capture)."""
    cfg, params, layout, caches, tables, pos, tokens, lane = \
        _int8_step_setup(arch, seed=1)
    step = tsteps.make_decode_step(cfg, params, caches, policy=FP32,
                                   layout=layout, batch_size=4, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("host data reached a tensor inside the step")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for _ in range(2):
        tok, pos, _ = step.fn(tokens, pos.copy(), tables, lane)
        tokens, pos = tok.numpy().copy(), pos.numpy().copy()
    assert (pos == step.fn.pos.numpy() + 1).all()


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("op", ["fused_matmul", "matmul_swiglu", "pdot",
                                "paged_decode_attention",
                                "paged_decode_partials"])
def test_int8_forms_never_fall_back(op):
    """An int8 weight dict or an int8 pool off the CPU goes to the kernel
    and raises where none can launch; `cuda` mode refuses CPU tensors:
    neither quietly runs the plain form."""
    w = lambda t: {"q": t(8, 16, dtype=torch.int8), "scale": t(16)}
    pool = lambda t: t(3, 4, 2, 8, dtype=torch.int8)
    calls = {
        "fused_matmul": lambda t: ops.fused_matmul(
            t(2, 8), w(t), prologue=ops.Prologue("rmsnorm", t(8))),
        "matmul_swiglu": lambda t: ops.matmul_swiglu(t(2, 8), w(t), w(t)),
        "pdot": lambda t: ops.pdot(t(2, 8), w(t),
                                   compute_dtype=torch.bfloat16,
                                   out_dtype=torch.float32),
        "paged_decode_attention": lambda t: ops.paged_decode_attention(
            t(1, 2, 8), pool(t), pool(t), t(1, 2, dtype=torch.int32),
            t(1, dtype=torch.int32), k_scale=t(3, 2), v_scale=t(3, 2)),
        "paged_decode_partials": lambda t: ops.paged_decode_partials(
            t(1, 2, 8), pool(t), pool(t), t(1, 2, dtype=torch.int32),
            t(1, dtype=torch.int32), k_scale=t(3, 2), v_scale=t(3, 2)),
    }[op]
    with ops.kernel_mode("cuda"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            calls(lambda *s, dtype=torch.float32: torch.zeros(s, dtype=dtype))
    with ops.kernel_mode("auto"):
        with pytest.raises(ValueError, match="CUDA"):
            calls(_meta)


def test_split_quantized_unpacks_and_passes_through():
    q, s = torch.zeros((4, 2), dtype=torch.int8), torch.ones(2)
    got = ops.split_quantized({"q": q, "scale": s})
    assert got[0] is q and got[1] is s
    w = torch.zeros(4, 2)
    assert ops.split_quantized(w) == (w, None)

"""PyTorch port, the mixture-of-experts family: mixtral-8x7b (and the
8x22b config) against the reference at its reduced config (2 `moe_local`
layers, d_model 64, 4 query heads over 2 KV heads, 4 experts top-2, d_ff
128, window 8), fp32 policy, on the CPU.

  * the config copies, the `mixtral-8x7b-draft` config, the parameter tree
    (router and stacked experts) and the weight converter;
  * the gated kernel's expert form: `expert_swiglu_plain` and
    `ops.expert_swiglu` against the reference's `ops.expert_swiglu` in
    `interpret` mode (the Pallas kernel vmapped over the experts) and in
    `ref` mode, at C = 16 and at C = 7 / 13 (no power of two); the
    planner's expert grids and each template's arithmetic
    (`gemm_emulate` per expert at the expert plan); an int8 dict refused;
  * the MoE layer (`moe_ffn_chunk` / `moe_decode` / `moe_full`) fused and
    unfused: random routing, a forced overflow (every token routed to one
    expert: pairs drop), exact ties in the router probabilities (the
    lowest expert index first), padded zero rows, and T > MOE_CHUNK (two
    dispatch chunks);
  * `block_full` / `block_chunk` / `block_decode` for `moe` and
    `moe_local`, fused and unfused (ring and paged caches);
  * teacher-forced logits of prefill and paged decode, of the chunk stack
    and of a verify pass, against the reference `lm`; ring decode across
    the window's wraps;
  * the engine (greedy) against the port's own direct loop, the decode
    step bit-equal to eager and free of host data; chunked prefill with
    the prefix cache, and speculation with the derived draft,
    token-identical to whole-prompt / plain decoding at a capacity no
    pair can overflow (a pass's capacity follows its rows);
  * `quantize_params` leaving the router and the experts in bf16;
  * the CLI: `--arch mixtral-8x7b --reduced` serves, the full config is
    refused before any weight is made.

Tolerances (tests/conftest.py): fp32 rtol = atol = 1e-4; bf16 2e-2.  The
chunk and verify cases widen the window to max_seq in both frameworks
(`sliding_window` 0 for speculation, which refuses any window): the
reduced window of 8 keeps ring caches, which the chunk stack refuses in
both.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import blocks as jblocks
from repro.core import embedding as jemb
from repro.core import mlp as jmlp
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.models import quantize as jquant
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import MIXTRAL_8X7B, REGISTRY, get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core import embedding as temb
from repro_torch.core import mlp as tmlp
from repro_torch.core.precision import FP32
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree
from repro_torch.models.quantize import quantize_params
from repro_torch.serving import InferenceEngine, Request, SpecConfig
from repro_torch.serving.kv_cache import prefill_scatter
from repro_torch.serving.sampling import device_lane

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
MAX_SEQ = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _plan(fused):
    """The reference's plan; its KV caches in fp32, as the port's fp32
    policy stores them."""
    return dataclasses.replace(UNSHARDED, fuse_epilogues=fused,
                               kv_cache_dtype="float32")


def _widen(cfg, window=MAX_SEQ):
    """The same model with its window at `window` (>= max_seq: every layer
    paged; 0: no window at all, what speculation needs)."""
    return dataclasses.replace(cfg, sliding_window=window)


@functools.lru_cache(maxsize=None)
def _model(window=None):
    """Reference weights with every norm scale perturbed off 1, converted
    through numpy -> (jcfg, tcfg, jparams, tparams) at the reduced config,
    its window widened to `window` in both frameworks when given."""
    jcfg, tcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    if window is not None:
        jcfg, tcfg = _widen(jcfg, window), _widen(tcfg, window)
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(23), jcfg, jnp.float32))
    rng = np.random.default_rng(23)
    norms = [seg[ln] for seg in tree["segments"] for ln in ("ln1", "ln2")]
    for p in norms + [tree["final_norm"]]:
        p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)
                      ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


def _layers(window=None, i=0):
    jcfg, tcfg, jp, tp = _model(window)
    return (jcfg, tcfg, jax.tree.map(lambda a: a[i], jp["segments"][0]),
            tptree.layer(tp["segments"][0], i))


# --------------------------------------------------------------------------
# configs and weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_config_copy_matches_reference(arch, reduced):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_params() == jcfg.n_params()
    if not reduced:
        # bf16 weights: 93.4 GB (8x7b) and 281.3 GB (8x22b)
        gb = {"mixtral-8x7b": 93.4, "mixtral-8x22b": 281.3}[arch]
        assert round(2 * tcfg.n_params() / 1e9, 1) == gb


def test_draft_matches_reference():
    jd, td = jax_config("mixtral-8x7b-draft"), REGISTRY["mixtral-8x7b-draft"]
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert td.schedule == (("attn", 2),) and td.n_experts == 0
    assert td.vocab == MIXTRAL_8X7B.vocab and td.mlp_act == "swiglu"


def _shapes(tree, path=""):
    """{leaf path: shape} of a tree whose leaves are arrays or shape
    tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)) and tree and not isinstance(
            tree[0], int):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{path}[{i}]"))
        return out
    return {path: tuple(getattr(tree, "shape", tree))}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_param_shapes_match_reference_at_full_size(arch):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    want = _shapes(jax.eval_shape(
        lambda k: jlm.init_lm(k, jcfg, jnp.bfloat16), jax.random.key(0)))
    assert _shapes(tlm.lm_param_shapes(tcfg)) == want
    moe = tlm.lm_param_shapes(tcfg)["segments"][0]["moe"]
    L, E, F = tcfg.n_layers, tcfg.d_model, tcfg.d_ff
    assert moe == {"wr": (L, E, 8), "wg": (L, 8, E, F), "wu": (L, 8, E, F),
                   "w2": (L, 8, F, E)}


def test_params_from_numpy_moe_tree():
    _, tcfg, jparams, tparams = _model()
    seg = tparams["segments"][0]
    assert set(seg) == {"ln1", "attn", "ln2", "moe"}
    assert set(seg["moe"]) == {"wr", "wg", "wu", "w2"}
    assert tuple(seg["moe"]["wg"].shape) == (2, 4, 64, 128)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))


def test_init_lm_draws_the_moe_tree():
    cfg = get_config(ARCH).reduced()
    p = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=3)
    moe = p["segments"][0]["moe"]
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "wr": (2, 64, 4), "wg": (2, 4, 64, 128), "wu": (2, 4, 64, 128),
        "w2": (2, 4, 128, 64)}
    assert abs(float(moe["wg"].std()) - 0.02) < 2e-3
    assert not torch.equal(moe["wg"][0, 0], moe["wg"][0, 1])


# --------------------------------------------------------------------------
# the expert form of the gated GEMM
# --------------------------------------------------------------------------

def _expert_inputs(C, seed, NE=4, K=64, N=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NE, C, K)).astype(np.float32),
            (0.1 * rng.standard_normal((NE, K, N))).astype(np.float32),
            (0.1 * rng.standard_normal((NE, K, N))).astype(np.float32))


@pytest.mark.parametrize("mode", ["interpret", "ref"])
@pytest.mark.parametrize("C", [16, 7, 13])
def test_expert_swiglu_matches_reference(C, mode):
    """fp32: the plain version, `ops.expert_swiglu` (auto: the wrapper's
    CPU path) and the port's `ref` mode against the reference's op in
    `interpret` mode (the vmapped Pallas kernel) and in `ref` mode."""
    xe, wg, wu = _expert_inputs(C, seed=C)
    with jops.kernel_mode(mode):
        want = np.asarray(jops.expert_swiglu(*map(jnp.asarray, (xe, wg, wu))))
    t = [torch.from_numpy(a) for a in (xe, wg, wu)]
    got = {"plain": tmm.expert_swiglu_plain(*t),
           "wrapper": tmm.expert_swiglu(*t),
           "auto": tops.expert_swiglu(*t)}
    with tops.kernel_mode("ref"):
        got["ref"] = tops.expert_swiglu(*t)
    for name, y in got.items():
        assert tuple(y.shape) == (4, C, 128), name
        np.testing.assert_allclose(_np(y), want, err_msg=name, **F32)


@pytest.mark.parametrize("C", [16, 13])
def test_expert_swiglu_bf16_matches_reference(C):
    """bf16 operands and output: the port's `ref` mode (the dots emitted
    at bf16, as the reference's) and the plain version (g and u kept in
    fp32, as the kernels keep them) against the reference's two modes."""
    xe, wg, wu = _expert_inputs(C, seed=40 + C)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (xe, wg, wu)]
    t = [torch.from_numpy(a).bfloat16() for a in (xe, wg, wu)]
    with jops.kernel_mode("ref"):
        jref = jops.expert_swiglu(*j)
    with jops.kernel_mode("interpret"):
        jint = jops.expert_swiglu(*j)
    with tops.kernel_mode("ref"):
        tref = tops.expert_swiglu(*t)
    assert tref.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tref), _np(jref), **BF16)
    np.testing.assert_allclose(_np(tmm.expert_swiglu_plain(*t)), _np(jint),
                               **BF16)


def test_expert_plan_grids():
    """The expert form's plans: the grid gains the expert dimension (the
    stream template's third; the wgmma template's third, splits x
    experts), the stream split is planned for every expert's blocks, and
    a K that would let a K tile cross an expert is refused."""
    decode = tmm.gemm_plan(2, 4096, 14336, gated=True, experts=8)
    assert decode.template == "stream"
    assert decode.grid == (56, decode.splits, 8)
    alone = tmm.gemm_plan(2, 4096, 14336, gated=True)
    assert len(alone.grid) == 2 and alone.splits >= decode.splits
    prefill = tmm.gemm_plan(640, 4096, 14336, gated=True, experts=8)
    assert prefill.template == "wgmma"
    assert prefill.grid == (5, 112, prefill.splits * 8)
    assert prefill.splits == 1            # 4480 tiles fill the card
    ragged = tmm.gemm_plan(37, 6144, 16384, gated=True, experts=8)
    assert ragged.grid[:2] == (1, 128)
    assert tmm.gemm_plan(2, 4096, 14336, gated=True, experts=1) == alone
    with pytest.raises(ValueError, match="multiple of 64"):
        tmm.gemm_plan(2, 4104, 256, gated=True, experts=8)


@pytest.mark.parametrize("C,kchunk", [(3, 64), (3, None), (37, 128),
                                      (37, None)])
def test_expert_templates_arithmetic(C, kchunk):
    """Each expert of a launch runs the gated template's arithmetic on its
    own slice: `gemm_emulate` per expert at the expert plan (split ranges
    in order, bf16 operands) against the plain version, bf16 output."""
    xe, wg, wu = (torch.from_numpy(a).bfloat16()
                  for a in _expert_inputs(C, seed=C + 1, K=256, N=64))
    plan = tmm.gemm_plan(C, 256, 64, gated=True, experts=4, kchunk=kchunk)
    assert plan.template == ("stream" if C <= 8 else "wgmma")
    want = tmm.expert_swiglu_plain(xe, wg, wu)
    for e in range(4):
        got = tmm.gemm_emulate(xe[e], wg[e], wu[e], plan=plan,
                               out_dtype=torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want[e]), **BF16)


def test_expert_swiglu_refuses_int8_and_counts_no_cpu_launch():
    xe, wg, wu = (torch.from_numpy(a) for a in _expert_inputs(4, seed=2))
    q = {"q": torch.zeros(tuple(wg.shape), dtype=torch.int8),
         "scale": torch.ones(4, 128)}
    with pytest.raises(TypeError, match="int8"):
        tops.expert_swiglu(xe, q, q)
    with pytest.raises(TypeError, match="bf16 only"):
        tmm.expert_swiglu(xe, q, q)
    n = tmm.expert_swiglu.launches
    tmm.expert_swiglu(xe, wg, wu)
    assert tmm.expert_swiglu.launches == n
    assert tops.launch_counters()["expert_swiglu"] is tmm.expert_swiglu
    with pytest.raises(ValueError, match="CUDA"):
        tmm._check_expert_swiglu(xe.bfloat16(), wg.bfloat16(), wu.bfloat16(),
                                 torch.bfloat16)


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def _moe_params(case, seed=5):
    """One layer's MoE weights (reference draw); `overflow` scales the
    router so that every token picks expert 2 first and drops follow;
    `tie` gives experts 1 and 3 the same router column (equal
    probabilities for every token)."""
    _, _, jl, _ = _layers()
    p = {k: np.array(v) for k, v in jl["moe"].items()}
    rng = np.random.default_rng(seed)
    if case == "overflow":
        p["wr"] = p["wr"].copy()
        p["wr"][:, 2] = 4.0 / np.sqrt(p["wr"].shape[0])
    if case == "tie":
        p["wr"] = p["wr"].copy()
        p["wr"][:, 3] = p["wr"][:, 1]
        p["wr"][:, 0] -= 0.05 * np.abs(rng.standard_normal(p["wr"].shape[0]))
    return p


def _moe_input(case, T, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, 64)).astype(np.float32)
    if case == "overflow":
        x = np.abs(x)                        # x . wr[:, 2] > 0 for every row
    if case == "padded":
        x[T // 2:] = 0.0                     # pad rows route and take slots
    return x


def _routing(tcfg, p, x):
    probs, top_w, top_i = tmlp._route(torch.from_numpy(x),
                                      torch.from_numpy(p["wr"]), cfg=tcfg,
                                      policy=FP32)
    return probs.numpy(), top_i.numpy()


MOE_CASES = ["random", "overflow", "tie", "padded"]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_full_matches_reference(case, fused):
    jcfg, tcfg, _, _ = _layers()
    p = _moe_params(case)
    x = _moe_input(case, 2 * 13).reshape(2, 13, 64)
    want, _ = jmlp.moe_full({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), plan=_plan(fused), cfg=jcfg,
                            policy=JFP32)
    got = tmlp.moe_full({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg=tcfg, policy=FP32,
                        fused=fused)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    probs, top_i = _routing(tcfg, p, x.reshape(-1, 64))
    _, jtop = jax.lax.top_k(jnp.asarray(probs), tcfg.top_k)
    np.testing.assert_array_equal(top_i, np.asarray(jtop))
    capacity = int(np.ceil(26 * 2 / 4 * 1.25))
    counts = np.bincount(top_i.reshape(-1), minlength=4)
    if case == "overflow":
        assert (top_i[:, 0] == 2).all() and counts[2] > capacity
    if case == "tie":
        assert (probs[:, 1] == probs[:, 3]).all()
        has1, has3 = (top_i == 1).any(1), (top_i == 3).any(1)
        # a tie at the top-k boundary keeps the lower index, 1
        assert (has1 & ~has3).sum() > 0 and not (has3 & ~has1).any()
    if case == "padded":
        # a zero row ties every expert: it takes experts 0 and 1
        assert (top_i[13:] == [0, 1]).all()


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_decode_matches_reference(case, fused):
    """A decode batch of 6 rows: capacity max(1, ceil(6 x 2 / 4 x 1.25))
    = 4 a expert; the overflow case drops."""
    jcfg, tcfg, _, _ = _layers()
    p = _moe_params(case, seed=8)
    x = _moe_input(case, 6, seed=9)
    want, _ = jmlp.moe_decode({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), plan=_plan(fused), cfg=jcfg,
                              policy=JFP32)
    got = tmlp.moe_decode({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), cfg=tcfg, policy=FP32,
                          fused=fused)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    if case == "overflow":
        # 6 first choices on expert 2 against 4 slots: two rows keep only
        # their second expert, and their output differs from the no-drop
        # layer's
        roomy = tmlp.moe_ffn_chunk(
            torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                                  p.items()}, cfg=tcfg, policy=FP32,
            capacity=12, fused=fused)
        differs = (roomy - got).abs().amax(1) > 1e-6
        assert differs.sum() == 2 and differs[-2:].all()


@pytest.mark.parametrize("capacity", [1, 3, 7])
def test_moe_ffn_chunk_capacities_match_reference(capacity):
    """moe_ffn_chunk at a fixed capacity, every case's routing in one
    chunk of 20 rows (random rows, then 10 zero rows)."""
    jcfg, tcfg, _, _ = _layers()
    p = _moe_params("random", seed=12)
    x = _moe_input("padded", 20, seed=13)
    want, _ = jmlp.moe_ffn_chunk(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                  in p.items()},
                                 plan=_plan(True), cfg=jcfg, policy=JFP32,
                                 capacity=capacity)
    got = tmlp.moe_ffn_chunk(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             cfg=tcfg, policy=FP32, capacity=capacity)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_moe_full_two_dispatch_chunks_matches_reference():
    """T = 8200 tokens > MOE_CHUNK: two chunks of 4100, each with its own
    capacity (1282) and running counts."""
    jcfg, tcfg, _, _ = _layers()
    assert tmlp._chunks(8200) == jmlp._chunks(8200) == 2
    assert tmlp.MOE_CHUNK == jmlp.MOE_CHUNK
    p = _moe_params("random", seed=14)
    x = _moe_input("random", 8200, seed=15).reshape(2, 4100, 64)
    want, _ = jmlp.moe_full({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), plan=_plan(True), cfg=jcfg,
                            policy=JFP32)
    got = tmlp.moe_full({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), cfg=tcfg, policy=FP32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [5, 13])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["moe", "moe_local"])
def test_block_full_matches_reference(kind, fused, S):
    """Prefill with the cache: `moe_local` keeps a ring of the window's 8
    slots (a 13-token prompt rolls it), `moe` a compact paged cache."""
    jcfg, tcfg, jl, tl = _layers()
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    jx, jcache, _ = jblocks.block_full(
        kind, jl, jnp.asarray(x), plan=_plan(fused), cfg=jcfg, policy=JFP32,
        with_cache=True, max_seq=32, compact_kv=True)
    tx, tcache = tblocks.block_full(kind, tl, torch.tensor(x), cfg=tcfg,
                                    policy=FP32, fused=fused, with_cache=True,
                                    max_seq=32, compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    assert set(tcache) == set(jcache) == {"k", "v"}
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **F32)
    assert tcache["k"].shape[1] == (8 if kind == "moe_local" else S)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["moe", "moe_local"])
def test_block_decode_matches_reference(kind, fused):
    """One decode step of 3 rows: `moe` over paged pools, `moe_local` over
    a ring of 8 slots (positions before, at and after the wrap); the
    caches written in place."""
    jcfg, tcfg, jl, tl = _layers()
    rng = np.random.default_rng(3)
    B, KV, hd = 3, jcfg.n_kv_heads, jcfg.head_dim
    x = rng.standard_normal((B, 64)).astype(np.float32)
    if kind == "moe":
        NB, BS = 9, 8
        state = {k: rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
                 for k in "kv"}
        tab = np.array([[2, 5, -1, -1], [0, 7, 1, -1], [4, 3, 6, 8]],
                       np.int32)
        pos = np.array([12, 20, 31], np.int32)
        sink = np.zeros((1, BS, KV, hd), np.float32)
        tcache = {k: torch.tensor(np.concatenate([v, sink]))
                  for k, v in state.items()}
        kw = dict(block_tables=tab, paged=True)
    else:
        state = {k: rng.standard_normal((B, 8, KV, hd)).astype(np.float32)
                 for k in "kv"}
        pos = np.array([3, 8, 29], np.int32)
        tcache = {k: torch.tensor(v) for k, v in state.items()}
        kw = dict(block_tables=None, paged=False)
    jcache = {k: jnp.asarray(v) for k, v in state.items()}
    jy, jc = jblocks.block_decode(
        kind, jl, jnp.asarray(x), jnp.asarray(pos), jcache,
        plan=_plan(fused), cfg=jcfg, policy=JFP32,
        block_tables=(None if kw["block_tables"] is None
                      else jnp.asarray(kw["block_tables"])),
        paged=kw["paged"])
    leaves = dict(tcache)
    ty, tc = tblocks.block_decode(
        kind, tl, torch.tensor(x), torch.tensor(pos), tcache, cfg=tcfg,
        policy=FP32, fused=fused, paged=kw["paged"],
        block_tables=(None if kw["block_tables"] is None
                      else torch.tensor(kw["block_tables"])))
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in "kv":
        assert tc[key] is leaves[key]
        got = tc[key][:-1] if kind == "moe" else tc[key]
        np.testing.assert_allclose(_np(got), _np(jc[key]), **F32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["moe", "moe_local"])
def test_block_chunk_matches_reference(kind, fused):
    """A chunk of 6 tokens a row at positions 10 and 3 (row 1 carries 4
    real tokens) into paged pools: 12 rows routed as a decode batch
    (capacity 8).  The window is widened to max_seq in both frameworks
    (a ring layer cannot chunk)."""
    jcfg, tcfg, jl, tl = _layers(window=MAX_SEQ)
    rng = np.random.default_rng(4)
    NB, BS, KV, hd, C = 10, 8, jcfg.n_kv_heads, jcfg.head_dim, 6
    pools = {k: rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
             for k in "kv"}
    tab = np.array([[3, 1, 7, -1], [0, 9, -1, -1]], np.int32)
    pos0, clen = np.array([10, 3], np.int32), np.array([6, 4], np.int32)
    x = rng.standard_normal((2, C, 64)).astype(np.float32)
    sink = np.zeros((1, BS, KV, hd), np.float32)
    tcache = {k: torch.tensor(np.concatenate([v, sink]))
              for k, v in pools.items()}
    jy, jc = jblocks.block_chunk(
        kind, jl, jnp.asarray(x), jnp.asarray(pos0), jnp.asarray(clen),
        {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(tab),
        plan=_plan(fused), cfg=jcfg, policy=JFP32)
    ty, tc = tblocks.block_chunk(
        kind, tl, torch.tensor(x), torch.tensor(pos0), torch.tensor(clen),
        tcache, torch.tensor(tab), cfg=tcfg, policy=FP32, fused=fused)
    real = np.arange(C)[None, :] < clen[:, None]
    np.testing.assert_allclose(_np(ty)[real], _np(jy)[real], **F32)
    for key in "kv":
        np.testing.assert_allclose(_np(tc[key][:NB]), _np(jc[key]), **F32)


# --------------------------------------------------------------------------
# the model, teacher-forced
# --------------------------------------------------------------------------

def _logits(ops_mod, emb_mod, cfg, params, x, fused, **plan):
    norm = ops_mod.norm_prologue(params["final_norm"], cfg.norm)
    if not fused:
        x, norm = ops_mod.norm(x, params["final_norm"], cfg.norm), None
    z = emb_mod.logits_local(x, params["embedding"]["unemb"], cfg=cfg,
                             norm=norm, **plan)
    return z[0] if isinstance(z, tuple) else z        # the reference: (z, _)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_teacher_forced_prefill_and_decode(layout, fused):
    """Exact-length prefill of 12 tokens a row (logits at every position),
    scattered into the decode layout, then 10 decode steps with each
    side's caches evolving on their own: `paged` widens the window to
    max_seq (every layer in the pool), `ring` keeps the reduced window of 8
    (the rings wrap past position 16)."""
    jcfg, tcfg, jp, tp = _model(MAX_SEQ if layout == "paged" else None)
    rng = np.random.default_rng(21)
    B, S, BS, NB, n_dec = 2, 12, 8, 10, 10
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    plan = _plan(fused)
    jx = jlm._embed_sequence(jp, {"tokens": jnp.asarray(tokens[:, :S])},
                             plan=plan, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=plan, cfg=jcfg, policy=JFP32, max_seq=MAX_SEQ,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(tokens[:, :S]), policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(
        tp, tx, cfg=tcfg, policy=FP32, max_seq=MAX_SEQ, fused=fused,
        compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(
        _np(_logits(tops, temb, tcfg, tp, tx.reshape(B * S, -1), fused,
                    policy=FP32)),
        _np(_logits(jops, jemb, jcfg, jp, jx.reshape(B * S, -1), fused,
                    plan=plan, policy=JFP32)), **F32)

    layout_ = tsteps.make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB,
                                       block_size=BS)
    paged = layout_.segments
    assert paged == ((layout == "paged"),)
    tc = tsteps.cache_layout(tcfg, layout_, batch_size=B, policy=FP32,
                             device="cpu")
    tables = np.full((B, layout_.max_blocks), -1, np.int32)
    tables[0, :3] = [4, 1, 7]
    tables[1, :3] = [0, 9, 3]
    slots = np.arange(B)
    prefill_scatter(tc, tcaches, torch.tensor(slots), torch.tensor(tables),
                    block_size=BS, paged_segments=paged)
    jc = tuple({k: jnp.zeros((v.shape[0], NB) + tuple(v.shape[2:])
                             if pg else tuple(v.shape), jnp.float32)
                for k, v in seg.items()} for seg, pg in zip(tc, paged))
    jc = make_prefill_scatter(paged, BS)(jc, jcaches, jnp.asarray(slots),
                                         jnp.asarray(tables))
    ttab, jtab = torch.tensor(tables), jnp.asarray(tables)
    jstep = jax.jit(functools.partial(
        jlm._run_segments_decode, plan=plan, cfg=jcfg, policy=JFP32,
        memory_len=0, paged_segments=paged))
    for i in range(n_dec):
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[:, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=plan, policy=JFP32)
        jxd, jc = jstep(jp, jxd, jnp.asarray(pos), jc, block_tables=jtab)
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tc = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tc, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused, paged_segments=paged)
        np.testing.assert_allclose(
            _np(_logits(tops, temb, tcfg, tp, txd, fused, policy=FP32)),
            _np(_logits(jops, jemb, jcfg, jp, jxd, fused, plan=plan,
                        policy=JFP32)), **F32)
        for tseg, jseg in zip(tc, jc):
            for key in tseg:
                got = tseg[key][:, :NB] if paged[0] else tseg[key]
                np.testing.assert_allclose(_np(got), _np(jseg[key]), **F32)


@pytest.mark.parametrize("fused", [True, False])
def test_chunk_stack_matches_reference(fused):
    """A 29-token prompt in chunks of 12 through `forward_chunk` (the
    window widened to max_seq in both): every chunk's hidden states,
    pools, position and token against the reference's; the last chunk's
    token equals the whole-prompt prefill's."""
    jcfg, tcfg, jp, tp = _model(MAX_SEQ)
    rng = np.random.default_rng(4)
    P, C, NB, BS = 29, 12, 12, 8
    prompt = rng.integers(0, tcfg.vocab, P, dtype=np.int32)
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, NB, BS)
    assert tsteps.chunk_support_reason(tcfg, layout) is None
    caches = tsteps.cache_layout(tcfg, layout, batch_size=1, policy=FP32,
                                 device="cpu")
    jcaches = tuple({k: jnp.asarray(v[:, :NB].numpy())
                     for k, v in seg.items()} for seg in caches)
    table = np.full((1, layout.max_blocks), -1, np.int32)
    table[0, :4] = rng.permutation(NB)[:4]
    plan = _plan(fused)
    for start in range(0, P, C):
        take = min(C, P - start)
        tok = np.zeros((1, C), np.int32)
        tok[0, :take] = prompt[start:start + take]
        targs = (torch.from_numpy(tok), torch.tensor([start]),
                 torch.tensor([take]))
        jargs = (jnp.asarray(tok), jnp.asarray([start], jnp.int32),
                 jnp.asarray([take], jnp.int32))
        jx, _, _ = jlm._run_chunk_stack(
            jp, *jargs, jcaches, jnp.asarray(table), plan=plan, cfg=jcfg,
            policy=JFP32, paged_segments=None)
        jtok, jcaches, jpos = jlm.forward_chunk(
            jp, *jargs, jcaches, jnp.asarray(table), plan=plan, cfg=jcfg,
            policy=JFP32)
        probe = tuple({k: v.clone() for k, v in seg.items()}
                      for seg in caches)
        tx, _, _ = tlm._run_chunk_stack(
            tp, *targs, probe, torch.from_numpy(table), cfg=tcfg,
            policy=FP32, fused=fused)
        ttok, out, tpos = tlm.forward_chunk(
            tp, *targs, caches, torch.from_numpy(table), cfg=tcfg,
            policy=FP32, fused=fused)
        assert out is caches
        np.testing.assert_allclose(tx.numpy()[0, :take],
                                   np.asarray(jx)[0, :take], **F32)
        for seg_t, seg_j in zip(caches, jcaches):
            for k in seg_j:
                np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                           np.asarray(seg_j[k]), **F32)
        assert int(tpos[0]) == int(jpos[0]) == start + take
        assert int(ttok[0]) == int(jtok[0])
    want, _, _ = tlm.forward_prefill(tp, torch.from_numpy(prompt[None]),
                                     cfg=tcfg, policy=FP32, max_seq=MAX_SEQ,
                                     compact_kv=True, fused=fused)
    assert int(ttok[0]) == int(want[0])


def test_verify_pass_matches_reference():
    """A verify pass of k + 1 = 5 tokens a row over 30- and 19-token
    prefixes (row 1: 3 real tokens): the choice at every real position,
    the pools and the positions against the reference's `forward_verify`,
    and the choices against step-by-step `forward_decode`."""
    jcfg, tcfg, jp, tp = _model(0)
    assert jcfg.sliding_window == 0
    NB, BS = 24, 8
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, NB, BS)
    caches = tsteps.cache_layout(tcfg, layout, batch_size=2, policy=FP32,
                                 device="cpu")
    table = np.full((2, layout.max_blocks), -1, np.int32)
    table[0, :6] = [3, 9, 1, 14, 20, 5]
    table[1, :4] = [0, 11, 7, 2]
    rng = np.random.default_rng(8)
    lens = np.array([30, 19], np.int32)
    tok = np.zeros((2, 32), np.int32)
    for b, n in enumerate(lens):
        tok[b, :n] = rng.integers(0, tcfg.vocab, n)
    tlm.forward_chunk(tp, torch.from_numpy(tok), torch.zeros(2,
                      dtype=torch.int32), torch.from_numpy(lens), caches,
                      torch.from_numpy(table), cfg=tcfg, policy=FP32)
    jcaches = tuple({k: jnp.asarray(v[:, :NB].numpy())
                     for k, v in seg.items()} for seg in caches)
    C = 5
    tokens = rng.integers(0, tcfg.vocab, (2, C)).astype(np.int32)
    clen = np.array([5, 3], np.int32)
    lane = {"temperature": np.zeros(2, np.float32),
            "top_k": np.zeros(2, np.int32), "seed": np.zeros(2, np.int32)}
    decode_caches = tuple({k: v.clone() for k, v in seg.items()}
                          for seg in caches)
    jch, jc, jpos = jlm.forward_verify(
        jp, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(clen),
        jcaches, jnp.asarray(table), plan=UNSHARDED, cfg=jcfg, policy=JFP32,
        lane={k: jnp.asarray(v) for k, v in lane.items()})
    tln = {k: torch.from_numpy(v) for k, v in lane.items()}
    tch, out, tpos = tlm.forward_verify(
        tp, torch.from_numpy(tokens), torch.from_numpy(lens),
        torch.from_numpy(clen), caches, torch.from_numpy(table), cfg=tcfg,
        policy=FP32, lane=tln)
    real = np.arange(C)[None, :] < clen[:, None]
    np.testing.assert_array_equal(tch.numpy()[real], np.asarray(jch)[real])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for seg_t, seg_j in zip(caches, jc):
        for k in seg_j:
            np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                       np.asarray(seg_j[k]), **F32)
    tab = torch.from_numpy(table)
    for j in range(C):
        t, _ = tlm.forward_decode(
            tp, torch.from_numpy(tokens[:, j]), torch.from_numpy(lens + j),
            decode_caches, cfg=tcfg, policy=FP32, block_tables=tab, lane=tln)
        for b in range(2):
            if j < clen[b]:
                assert int(t[b]) == int(tch[b, j])


# --------------------------------------------------------------------------
# the engine and the decode step
# --------------------------------------------------------------------------

def _direct(cfg, params, prompt, n_new, fused, block_size=16):
    """Unpadded prefill + greedy decode loop outside the engine, batch 1
    (capacity 1: a token's two experts never overflow)."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True, fused=fused)
    layout = tsteps.make_paged_layout(cfg, MAX_SEQ,
                                      -(-MAX_SEQ // block_size), block_size)
    state = tsteps.cache_layout(cfg, layout, batch_size=1, policy=FP32,
                                device="cpu")
    table = torch.arange(layout.max_blocks, dtype=torch.int32)[None]
    prefill_scatter(state, caches, torch.arange(1), table,
                    block_size=block_size, paged_segments=layout.segments)
    toks = [int(tok[0])]
    for _ in range(n_new - 1):
        tok, state = tlm.forward_decode(params, tok, pos, state, cfg=cfg,
                                        policy=FP32, block_tables=table,
                                        fused=fused,
                                        paged_segments=layout.segments)
        pos = pos + 1
        toks.append(int(tok[0]))
    return toks


def _no_drop(cfg):
    """The config with capacity_factor NE / K: an expert's buffer then has
    a slot for every row a pass routes, so no pair ever drops.  A pass's
    capacity follows its row count (a chunk of 8 rows against a 26-row
    prefill, a verify pass of 10 rows against a 2-row decode step), so
    only without drops must two schedules of the same tokens agree."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused,window", [(True, None), (False, None),
                                          (True, MAX_SEQ)])
def test_engine_matches_direct_loop(fused, window):
    """Batch 2 (decode capacity 2 an expert: two rows never overflow),
    prompts of distinct lengths (one exact-length prefill each, as the
    direct loop's): greedy tokens equal, no block leaked.  The reduced
    window of 8 decodes over rings; widened, over the pool."""
    _, tcfg, _, tp = _model(window)
    lengths = (5, 11, 7, 13)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, fuse_epilogues=fused, device="cpu")
    assert all(eng.runner.layout.segments) == (window is not None)
    for uid, p in enumerate(_prompts(tcfg, lengths, seed=3)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(r.output) for r in done] == [10] * 4
    for req in done:
        assert _direct(tcfg, tp, req.prompt, 10, fused) == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_engine_chunked_prefix_cache_matches_whole_prompt():
    """The widened config behind the chunked policy with the prefix cache:
    a shared 20-token prefix, chunks of 8; tokens equal to whole-prompt
    FCFS serving (`_no_drop`), the cache hit, no block leaked."""
    from repro_torch.serving import make_policy
    _, tcfg, _, tp = _model(MAX_SEQ)
    tcfg = _no_drop(tcfg)
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, tcfg.vocab, 20, dtype=np.int32)
    prompts = [np.concatenate([prefix, p])
               for p in _prompts(tcfg, (6, 9, 4), seed=6)]

    def serve(**kw):
        eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                              policy=FP32, device="cpu", **kw)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out = {r.uid: r.output for r in eng.run()}
        return eng, out

    _, want = serve()
    eng, got = serve(scheduler=make_policy("chunked", chunk_tokens=8,
                                           cache_aware=True),
                     prefix_cache=True)
    assert got == want
    st = eng.stats()
    assert st.prefill_chunks > 0 and st.prefix_cache_hit_rate > 0
    eng.prefix_cache.clear()
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_spec_chain_with_derived_draft_is_token_identical():
    """Chain speculation (k 4) on the config without a window (the spec
    gate refuses any window, as the reference's does): greedy tokens equal
    to plain decoding's (`_no_drop`), with the derived dense draft and
    with "self"."""
    _, tcfg, _, tp = _model(0)
    tcfg = _no_drop(tcfg)
    reqs = lambda: [Request(uid=u, prompt=p, max_new_tokens=9)
                    for u, p in enumerate(_prompts(tcfg, (5, 14, 9), 11))]

    def serve(spec=None):
        eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                              policy=FP32, device="cpu", spec=spec)
        for r in reqs():
            eng.submit(r)
        out = {r.uid: r.output for r in eng.run()}
        assert eng.allocator.num_free == eng.allocator.num_blocks
        return eng, out

    _, plain = serve()
    for draft in ("auto", "self"):
        eng, got = serve(SpecConfig(draft=draft, k=4))
        assert got == plain, draft
        assert eng.runner.draft_cfg.n_experts == (0 if draft == "auto"
                                                  else 4)
        assert eng.stats().spec_proposed_tokens > 0


def _step_setup(window, seed=2, B=4, BS=4):
    _, cfg, _, params = _model(window)
    rng = np.random.default_rng(seed)
    layout = tsteps.make_paged_layout(cfg, 32, B * (32 // BS), BS)
    caches = tsteps.cache_layout(cfg, layout, batch_size=B, policy=FP32,
                                 device="cpu")
    for seg in caches:
        for leaf in seg.values():
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    tables = rng.permutation(layout.num_blocks).reshape(
        B, layout.max_blocks).astype(np.int32)
    pos = rng.integers(3, 24, B).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, B).astype(np.int32)
    lane = {"temperature": np.array([0.0, 0.8, 1.2, 0.0], np.float32),
            "top_k": np.array([0, 40, 0, 5], np.int32),
            "seed": np.array([3, 101, 2**31 - 7, 9], np.int64)}
    step = tsteps.make_decode_step(cfg, params, caches, policy=FP32,
                                   layout=layout, batch_size=B,
                                   device=torch.device("cpu"))
    return cfg, params, layout, caches, tables, pos, tokens, lane, step


@pytest.mark.parametrize("window", [None, MAX_SEQ], ids=["ring", "paged"])
def test_decode_step_bit_equal_and_free_of_host_data(window, monkeypatch):
    """The MoE decode step (routing, dispatch, the experts) against the
    eager `forward_decode` over 4 steps, bit for bit, then 2 more steps
    with `torch.tensor` / `as_tensor` / `from_numpy` made to raise (the
    CPU's proxy for a CUDA graph capture)."""
    cfg, params, layout, caches, tables, pos, tokens, lane, step = \
        _step_setup(window)
    eager = tuple({k: v.clone() for k, v in seg.items()} for seg in caches)
    tok_e, pos_e = torch.tensor(tokens), torch.tensor(pos)
    tok_s, pos_s = tokens.copy(), pos.copy()
    for _ in range(4):
        got, got_pos, _ = step.fn(tok_s, pos_s, tables, lane)
        want, _ = tlm.forward_decode(
            params, tok_e, pos_e, eager, cfg=cfg, policy=FP32,
            block_tables=torch.tensor(tables), lane=device_lane(lane, "cpu"),
            paged_segments=layout.segments)
        assert torch.equal(got, want.to(torch.int32))
        for seg_s, seg_e in zip(caches, eager):
            for k in seg_s:
                assert torch.equal(seg_s[k], seg_e[k]), k
        tok_s, pos_s = got.numpy().copy(), pos_s + 1
        tok_e, pos_e = want, pos_e + 1

    def refuse(*args, **kwargs):
        raise AssertionError("host data reached a tensor inside the step")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    for _ in range(2):
        tok, p1, _ = step.fn(tok_s, pos_s.copy(), tables, lane)
        tok_s, pos_s = tok.numpy().copy(), p1.numpy().copy()


# --------------------------------------------------------------------------
# int8 weights, the CLI
# --------------------------------------------------------------------------

def test_quantize_params_leaves_the_experts_bf16():
    """The router and the experts stay as they are (the reference's rule:
    4-D expert stacks by rank, `wr` by name); the attention projections and
    the head become int8, bit-equal to the reference's."""
    _, tcfg, jp, tp = _model()
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tbf = tlm.params_from_numpy(jax.tree.map(np.asarray, bf), tcfg,
                                dtype=torch.bfloat16, device="cpu")
    q = quantize_params(tbf)
    jq = jquant.quantize_params(bf)
    for k in ("wr", "wg", "wu", "w2"):
        leaf = q["segments"][0]["moe"][k]
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        assert leaf is tbf["segments"][0]["moe"][k]
        assert not isinstance(jq["segments"][0]["moe"][k], dict)
    for k in ("wq", "wk", "wv", "wo"):
        leaf, jleaf = q["segments"][0]["attn"][k], jq["segments"][0]["attn"][k]
        assert leaf["q"].dtype == torch.int8
        np.testing.assert_array_equal(leaf["q"].numpy(),
                                      np.asarray(jleaf["q"]))
    assert q["embedding"]["unemb"]["q"].dtype == torch.int8


def test_cli_serves_the_reduced_config(capsys):
    assert tserve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--batch", "2",
                        "--prompt-len", "12", "--min-prompt-len", "5",
                        "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    # the reduced window (8) keeps ring caches: no prefix cache, and why
    assert "prefix cache disabled for mixtral-8x7b-reduced" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_cli_refuses_a_config_that_does_not_fit(arch, monkeypatch, capsys):
    """At full size the CLI refuses before it makes a weight: the weight
    bytes against the device's memory (an 80 GB card here)."""
    monkeypatch.setattr(tserve, "device_memory_bytes", lambda dev: 80 * 10**9)

    def no_init(*a, **k):
        raise AssertionError("weights made before the size check")
    monkeypatch.setattr(tserve.lm, "init_lm", no_init)
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--arch", arch, "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    gb = {"mixtral-8x7b": "93.4", "mixtral-8x22b": "281.3"}[arch]
    assert f"{gb} GB" in err and "80.0 GB" in err

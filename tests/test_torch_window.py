"""PyTorch port, sliding-window serving: gemma3-27b (5 local : 1 global
layers, GELU MLP) and hymba-1.5b's hybrid_local layers with ring KV caches,
against the reference at the reduced configs (window 8 under max_seq 128;
gemma3 local 2 / attn 1 / local 2), on the CPU:

  * the gemma3 config copy and the weight converter, at full size too
    (shapes only);
  * `ring_from_full` and the dense decode attention: the plain version of
    the CUDA kernel against the Pallas `decode_attention` in interpret mode
    and the reference's oracle, and the port's oracle against the
    reference's;
  * `attn_decode` on ring and linear caches, `block_full` / `block_decode`
    for local and hybrid_local with ring caches, against the reference's
    (`paged=False`);
  * teacher-forced logits through an exact-length prefill past the window
    and decode steps across several wraps, paged global and ring local
    segments mixed, against the reference `lm`;
  * the engine against the port's own direct unpadded loop (free-running
    engine tokens are never compared across frameworks), ring rows written
    at admission, recompute preemption, the admission scatter's ring leaves.

Tolerances: fp32 rtol = atol = 1e-4 (sum order); bf16 2e-2 (one bf16
rounding).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as jattn
from repro.core import blocks as jblocks
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
from repro.kernels import flash_decode as jfd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import GEMMA3_27B, get_config
from repro_torch.core import attention as tattn
from repro_torch.core import blocks as tblocks
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.steps import cache_layout, make_paged_layout
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.kv_cache import prefill_scatter

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

ARCHS = ("gemma3-27b", "hymba-1.5b")
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


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Reference weights with every norm scale perturbed off 1, converted
    through numpy -> (jcfg, tcfg, jparams, tparams) at the reduced
    config (window 8)."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(17), jcfg, jnp.float32))
    rng = np.random.default_rng(17)
    scales = [(tree["final_norm"], "scale")]
    for seg in tree["segments"]:
        scales += [(seg[k], "scale") for k in ("ln1", "ln2") if k in seg]
        if "ssm" in seg:
            scales.append((seg["ssm"], "norm_scale"))
    for node, key in scales:
        node[key] = (1 + 0.1 * rng.standard_normal(node[key].shape)
                     ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


# --------------------------------------------------------------------------
# config and weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_gemma3_config_copy_matches_reference(reduced):
    jcfg, tcfg = jax_config("gemma3-27b"), get_config("gemma3-27b")
    assert tcfg is GEMMA3_27B
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        assert tcfg.schedule == (("local", 2), ("attn", 1), ("local", 2))
        assert tcfg.sliding_window == 8 and tcfg.max_seq == 128
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_params() == jcfg.n_params()
    assert reduced or round(tcfg.n_params() / 1e9, 2) == 21.25


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)) and tree and not isinstance(
            tree[0], int):
        items = enumerate(tree)
    else:
        return {path: tuple(getattr(tree, "shape", tree))}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


def test_gemma3_param_shapes_match_reference_at_full_size():
    want = _shapes(jax.eval_shape(lambda: jlm.init_lm(
        jax.random.key(0), jax_config("gemma3-27b"))))
    got = _shapes(tlm.lm_param_shapes(get_config("gemma3-27b")))
    assert got == want
    assert got["/segments/0/attn/wq"] == (5, 5376, 4096)
    assert got["/segments/0/mlp/w1"] == (5, 5376, 21504)
    assert len(got) == 21 * 8 + 3


def test_params_from_numpy_gemma3_tree():
    jcfg, tcfg, jparams, tparams = _model("gemma3-27b")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    tree = jax.tree.map(np.asarray, jparams)
    tree["segments"][2]["attn"]["wk"] = tree["segments"][2]["attn"]["wk"][
        :, :, :8]
    with pytest.raises(ValueError, match="wk"):
        tlm.params_from_numpy(tree, tcfg, device="cpu")


def test_kind_paged_rule():
    """Full-context layers page their KV; a window shorter than max_seq
    keeps a ring; a window no shorter than max_seq is paged."""
    tcfg = get_config("hymba-1.5b").reduced()
    layout = make_paged_layout(tcfg, MAX_SEQ, 8, 16)
    assert layout.segments == (True, False, True)
    assert tblocks.kind_cache_len("hybrid_local", tcfg, MAX_SEQ) == 8
    wide = dataclasses.replace(tcfg, sliding_window=MAX_SEQ)
    assert tblocks.kind_paged("hybrid_local", wide, MAX_SEQ)
    g = get_config("gemma3-27b")
    assert make_paged_layout(g, 2048, 8, 16).segments == (
        (False, True) * 10 + (False,))
    assert all(make_paged_layout(g, 1024, 8, 16).segments)


# --------------------------------------------------------------------------
# ring caches and the dense decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [5, 8, 21])
def test_ring_from_full_matches_reference(S):
    """S < W (tail padded), S = W, and S > W with S % W != 0 (rolled)."""
    x = np.random.default_rng(S).standard_normal((2, S, 3, 4)).astype(
        np.float32)
    got = tattn.ring_from_full(torch.tensor(x), 8)
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(jattn.ring_from_full(
                                      jnp.asarray(x), 8)))
    for p in range(max(0, S - 8), S):             # slot = position % W
        np.testing.assert_array_equal(_np(got[:, p % 8]), x[:, p])


DECODE_CASES = [  # H, KV, D, S, window
    (4, 4, 64, 200, 0),          # G = 1, S not a multiple of block_kv 64
    (8, 4, 128, 136, 0),         # G = 2
    (10, 2, 64, 256, 0),         # G = 5
    (8, 4, 128, 200, 50),        # G = 2, window
    (10, 2, 64, 136, 64),        # G = 5, window
]


def _decode_inputs(case, dtype, seed=0):
    H, KV, D, S, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    k = rng.standard_normal((4, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((4, S, KV, D)).astype(np.float32)
    ln = np.array([1, S, int(rng.integers(2, S)), int(rng.integers(2, S))],
                  np.int32)
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)] + [jnp.asarray(ln)],
            [torch.tensor(a).to(td) for a in (q, k, v)] + [torch.tensor(ln)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"H{c[0]}KV{c[1]}D{c[2]}S{c[3]}w{c[4]}")
def test_decode_attention_plain_matches_pallas_and_oracle(case, dtype):
    win = case[4]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _decode_inputs(case, dtype)
    got = tfd.decode_attention_plain(tq, tk, tv, tl, window=win)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jfd.decode_attention(jq, jk, jv, jl, window=win, block_kv=64,
                                  interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl, window=win)
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    port_oracle = tref.decode_attention_ref(tq, tk, tv, tl, window=win)
    np.testing.assert_allclose(_np(port_oracle), _np(oracle), **tol)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: f"H{c[0]}KV{c[1]}D{c[2]}S{c[3]}w{c[4]}")
def test_decode_attention_plain_splits_match_pallas_and_oracle(case, dtype,
                                                               splits):
    """The plain version at the kernel's split count (`splits=`: ranges of
    whole 32-position stages, each folded stage by stage, the partials
    merged) against the Pallas kernel in interpret mode and the oracle."""
    win = case[4]
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _decode_inputs(case, dtype)
    got = tfd.decode_attention_plain(tq, tk, tv, tl, window=win,
                                     splits=splits)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = jfd.decode_attention(jq, jk, jv, jl, window=win, block_kv=64,
                                  interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl, window=win)
    tol = F32 if dtype == "f32" else BF16
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)


@pytest.mark.parametrize("window", [0, 300])
def test_decode_attention_plain_chunks_match_oracle(window):
    """S = 1100 walks three 512-position chunks, the last one ragged; with
    a window the first chunk is dead for the long rows."""
    case = (8, 4, 64, 1100, window)
    (jq, jk, jv, jl), (tq, tk, tv, tl) = _decode_inputs(case, "f32", seed=1)
    got = tfd.decode_attention_plain(tq, tk, tv, tl, window=window)
    oracle = jref.decode_attention_ref(jq, jk, jv, jl, window=window)
    np.testing.assert_allclose(_np(got), _np(oracle), **F32)


# --------------------------------------------------------------------------
# attention and blocks on ring caches
# --------------------------------------------------------------------------

def _layer_of(arch, seg):
    jcfg, tcfg, jp, tp = _model(arch)
    return (jax.tree.map(lambda a: a[0], jp["segments"][seg]),
            tptree.layer(tp["segments"][seg], 0))


# pos per row: < W - 1, W - 1, W, and after several wraps (W = 8)
RING_POS = np.array([3, 7, 8, 29], np.int32)
LINEAR_POS = np.array([0, 7, 12, 15], np.int32)


def _dense_cache(rng, B, W, cfg):
    shape = (B, W, cfg.n_kv_heads, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k", "v")}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("ring", [True, False], ids=["ring", "linear"])
def test_attn_decode_matches_reference(ring, fused):
    """A ring of W = window slots, or a linear cache of 16 rows under the
    window of 8; the new K/V lands in place at pos % W (ring) / pos."""
    jcfg, tcfg, _, _ = _model("gemma3-27b")
    jlayer, tlayer = _layer_of("gemma3-27b", 0)
    rng = np.random.default_rng(5 + ring)
    W = 8 if ring else 16
    pos = RING_POS if ring else LINEAR_POS
    B = len(pos)
    cache = _dense_cache(rng, B, W, tcfg)
    x = rng.standard_normal((B, 64)).astype(np.float32)
    jc = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in cache.items()}
    tc = {k: torch.tensor(v).bfloat16() for k, v in cache.items()}
    jkw, tkw = {}, {}
    if fused:
        jkw = dict(norm=jops.norm_prologue(jlayer["ln1"], jcfg.norm),
                   residual=jnp.asarray(x))
        tkw = dict(norm=tops.norm_prologue(tlayer["ln1"], tcfg.norm),
                   residual=torch.tensor(x))
    jy, jc = jattn.attn_decode(jlayer["attn"], jnp.asarray(x),
                               jnp.asarray(pos), jc, plan=_plan(fused),
                               cfg=jcfg, policy=JFP32, window=8, **jkw)
    k_leaf = tc["k"]
    ty, tc = tattn.attn_decode(tlayer["attn"], torch.tensor(x),
                               torch.tensor(pos), tc, cfg=tcfg, policy=FP32,
                               window=8, **tkw)
    assert tc["k"] is k_leaf                          # written in place
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **BF16)
        slot = pos % W if ring else pos
        changed = np.abs(_np(tc[key]) - cache[key]).max(axis=(2, 3)) > 0.05
        assert np.array_equal(np.flatnonzero(changed.any(0)),
                              np.unique(slot))


BLOCK_CASES = [("gemma3-27b", 0, "local"), ("hymba-1.5b", 1, "hybrid_local")]


@pytest.mark.parametrize("S", [5, 13])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[2])
def test_block_full_ring_cache_matches_reference(case, fused, S):
    """Prefill with the cache: a ring of the window's 8 slots, shorter
    prompts padded at the tail, longer ones rolled."""
    arch, seg, kind = case
    jcfg, tcfg, _, _ = _model(arch)
    assert jcfg.schedule[seg][0] == kind
    jlayer, tlayer = _layer_of(arch, seg)
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    jx, jcache, _ = jblocks.block_full(
        kind, jlayer, jnp.asarray(x), plan=_plan(fused), cfg=jcfg,
        policy=JFP32, with_cache=True, max_seq=MAX_SEQ, compact_kv=True)
    tx, tcache = tblocks.block_full(kind, tlayer, torch.tensor(x), cfg=tcfg,
                                    policy=FP32, fused=fused, with_cache=True,
                                    max_seq=MAX_SEQ, compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    assert set(tcache) == set(jcache)
    for key in tcache:
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **F32)
    assert tcache["k"].shape[1] == 8


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[2])
def test_block_decode_ring_matches_reference(case, fused):
    """One decode step against a ring (and hymba's SSM state), in place."""
    arch, seg, kind = case
    jcfg, tcfg, _, _ = _model(arch)
    jlayer, tlayer = _layer_of(arch, seg)
    rng = np.random.default_rng(9)
    B = len(RING_POS)
    state = _dense_cache(rng, B, 8, tcfg)
    if tcfg.has_ssm:
        Hp, P, N = tcfg.padded_ssm_heads(), tcfg.ssm_head_dim, tcfg.ssm_state
        state.update(h=rng.standard_normal((B, Hp, P, N)),
                     cx=rng.standard_normal((B, 3, Hp * P)),
                     cbc=rng.standard_normal((B, 3, 2 * N)))
    state = {k: v.astype(np.float32) for k, v in state.items()}
    cd = {k: (jnp.bfloat16, torch.bfloat16) if k in "kv"
          else (jnp.float32, torch.float32) for k in state}
    jcache = {k: jnp.asarray(v).astype(cd[k][0]) for k, v in state.items()}
    tcache = {k: torch.tensor(v).to(cd[k][1]) for k, v in state.items()}
    x = rng.standard_normal((B, 64)).astype(np.float32)
    jy, jc = jblocks.block_decode(kind, jlayer, jnp.asarray(x),
                                  jnp.asarray(RING_POS), jcache,
                                  plan=_plan(fused), cfg=jcfg, policy=JFP32,
                                  paged=False)
    leaves = dict(tcache)
    ty, tc = tblocks.block_decode(kind, tlayer, torch.tensor(x),
                                  torch.tensor(RING_POS), tcache, cfg=tcfg,
                                  policy=FP32, block_tables=None,
                                  fused=fused, paged=False)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    for key in state:
        assert tc[key] is leaves[key]                 # written in place
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]),
                                   **(BF16 if key in "kv" else F32))


# --------------------------------------------------------------------------
# the model, teacher-forced across several wraps
# --------------------------------------------------------------------------

def _logits(ops_mod, emb_mod, cfg, params, x, fused, **plan):
    norm = ops_mod.norm_prologue(params["final_norm"], cfg.norm)
    if not fused:
        x, norm = ops_mod.norm(x, params["final_norm"], cfg.norm), None
    z = emb_mod.logits_local(x, params["embedding"]["unemb"], cfg=cfg,
                             norm=norm, **plan)
    return z[0] if isinstance(z, tuple) else z        # the reference: (z, _)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_ring_decode_matches_reference(arch, fused):
    """Exact-length prefill of 12 tokens (past the window of 8), scattered
    into the decode layout (paged global, ring local segments), then 20
    decode steps through positions 12..31 — the rings wrap twice — with
    each side's caches evolving on their own.  Both sides store K/V in fp32
    (the port's fp32 policy; the reference's plan.kv_cache_dtype), so the
    comparison is at the fp32 tolerance; the caches are held to each other
    after every step."""
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(21)
    B, S, BS, NB, n_dec = 2, 12, 8, 10, 20
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

    layout = make_paged_layout(tcfg, MAX_SEQ, num_blocks=NB, block_size=BS)
    paged = layout.segments
    assert paged == tuple(jblocks.kind_paged(k, jcfg, MAX_SEQ)
                          for k, _ in jcfg.schedule)
    assert not all(paged) and any(paged)
    tc = cache_layout(tcfg, layout, batch_size=B, policy=FP32, device="cpu")
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    tables[0, :4] = [4, 1, 7, 2]
    tables[1, :4] = [0, 9, 3, 5]
    slots = np.array([1, 0], np.int32)
    prefill_scatter(tc, tcaches, torch.tensor(slots), torch.tensor(tables),
                    block_size=BS, paged_segments=paged)
    jc = []
    for seg, pg in zip(tc, paged):
        d = {k: jnp.zeros((v.shape[0], NB) + tuple(v.shape[2:])
                          if pg and k in ("k", "v") else tuple(v.shape),
                          jnp.float32) for k, v in seg.items()}
        jc.append(d)
    jc = make_prefill_scatter(paged, BS)(tuple(jc), jcaches,
                                         jnp.asarray(slots),
                                         jnp.asarray(tables))

    def held(tc, jc):
        for tseg, jseg, pg in zip(tc, jc, paged):
            for key in tseg:
                got = tseg[key][:, :NB] if pg and key in "kv" else tseg[key]
                np.testing.assert_allclose(_np(got), _np(jseg[key]), **F32)

    held(tc, jc)
    order = np.argsort(slots)                 # slot b holds prompt row
    dtab = tables[order]
    ttab, jtab = torch.tensor(dtab), jnp.asarray(dtab)
    jstep = jax.jit(functools.partial(
        jlm._run_segments_decode, plan=plan, cfg=jcfg, policy=JFP32,
        memory_len=0, paged_segments=paged))
    for i in range(n_dec):
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[order, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=plan, policy=JFP32)
        jxd, jc = jstep(jp, jxd, jnp.asarray(pos), jc, block_tables=jtab)
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tc = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tc, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused,
            paged_segments=paged)
        np.testing.assert_allclose(_np(txd), _np(jxd), **F32)
        np.testing.assert_allclose(
            _np(_logits(tops, temb, tcfg, tp, txd, fused, policy=FP32)),
            _np(_logits(jops, jemb, jcfg, jp, jxd, fused, plan=plan,
                        policy=JFP32)), **F32)
        held(tc, jc)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _direct(cfg, params, prompt, n_new, fused=True, block_size=16):
    """Unpadded prefill + greedy decode loop outside the engine ->
    (tokens, the prefill's caches)."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True, fused=fused)
    layout = make_paged_layout(cfg, MAX_SEQ, -(-MAX_SEQ // block_size),
                               block_size)
    state = cache_layout(cfg, layout, batch_size=1, policy=FP32,
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
    return toks, caches


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ring_matches_direct_loop(arch, fused):
    """Prompts shorter and longer than the window, decoding across its
    wraps: exact-length prefill, greedy tokens equal to the direct loop's,
    no block leaks."""
    _, tcfg, _, tp = _model(arch)
    lengths = (5, 11, 7, 13)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, fuse_epilogues=fused, device="cpu")
    assert not all(eng.runner.layout.segments)
    assert eng.runner.bucket_for(11) == 11
    for uid, p in enumerate(_prompts(tcfg, lengths, seed=3)):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
    done = sorted(eng.run(), key=lambda r: r.uid)
    st = eng.stats()
    assert st.padded_nar_tokens == st.nar_tokens == sum(lengths)
    for req in done:
        assert _direct(tcfg, tp, req.prompt, 12, fused)[0] == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_writes_ring_rows_at_admission(arch):
    """Two one-token requests (one past the window) admit into slots 0 and
    1 and retire: each slot's ring rows hold its prompt's prefill ring;
    slot 2 stays zero."""
    _, tcfg, _, tp = _model(arch)
    prompts = _prompts(tcfg, (11, 6), seed=4)
    eng = InferenceEngine(tcfg, tp, batch_size=3, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=1))
    eng.run()
    rings = [i for i, pg in enumerate(eng.runner.layout.segments) if not pg]
    assert rings
    for slot, prompt in enumerate(prompts):
        _, caches = _direct(tcfg, tp, prompt, 1)
        for i in rings:
            for key in eng.runner.caches[i]:
                np.testing.assert_allclose(
                    _np(eng.runner.caches[i][key][:, slot]),
                    _np(caches[i][key][:, 0]), **F32)
    for i in rings:
        for leaf in eng.runner.caches[i].values():
            assert not leaf[:, 2].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ring_preemption_recompute_matches_direct_loop(arch):
    """A 7-block pool of 4-token blocks cannot hold both slots' growth:
    recompute preemption re-prefills the evicted request's prompt and
    output at exact length, rebuilding its ring rows; tokens equal the
    direct loop's and no block leaks."""
    _, tcfg, _, tp = _model(arch)
    prompts = _prompts(tcfg, (9, 6, 10), seed=6)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, block_size=4, kv_pool_blocks=7,
                          device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=10))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert eng.stats().preemptions > 0
    for req in done:
        assert _direct(tcfg, tp, req.prompt, 10)[0] == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_prefill_scatter_ring_leaves_go_to_rows():
    """A ring leaf is named k / v like a pool: with the layout's flags it
    scatters into its slots' rows, and the pool of the paged segment
    receives only the assigned blocks."""
    rng = np.random.default_rng(8)
    B, W, KV, hd, BS, NB, S = 3, 4, 2, 4, 2, 5, 3
    ring = {k: torch.zeros((1, B, W, KV, hd)) for k in ("k", "v")}
    pool = {k: torch.zeros((1, NB + 1, BS, KV, hd)) for k in ("k", "v")}
    g_ring = {k: torch.tensor(rng.standard_normal((1, 2, W, KV, hd)),
                              dtype=torch.float32) for k in ("k", "v")}
    g_pool = {k: torch.tensor(rng.standard_normal((1, 2, S, KV, hd)),
                              dtype=torch.float32) for k in ("k", "v")}
    tables = torch.tensor([[3, 1, -1], [0, 4, -1]], dtype=torch.int32)
    prefill_scatter((ring, pool), (g_ring, g_pool),
                    torch.tensor([2, 0]), tables, block_size=BS,
                    paged_segments=(False, True))
    for k in ("k", "v"):
        assert torch.equal(ring[k][:, 2], g_ring[k][:, 0])
        assert torch.equal(ring[k][:, 0], g_ring[k][:, 1])
        assert not ring[k][:, 1].any()
        assert torch.equal(pool[k][:, 3], g_pool[k][:, 0, :2])
        assert torch.equal(pool[k][:, 1, :1], g_pool[k][:, 0, 2:])
        assert torch.equal(pool[k][:, 0], g_pool[k][:, 1, :2])
        assert not pool[k][:, 2].any() and not pool[k][:, NB].any()

"""PyTorch port, the SSM / hybrid serving path: hymba-1.5b (attention and
Mamba2 heads in parallel, SwiGLU MLP) and mamba2-2.7b (attention-free SSD
blocks) against the reference at their reduced configs (4 and 2 layers,
d_model 64, 8 SSM heads of 16 padded to 16, state 16), fp32 policy, on the
CPU:

  * the config copies and the weight converter, at full size too (shapes
    only: the padded w_x / w_z / w_out of hymba's 64 heads);
  * `block_full` / `block_decode` for kinds hybrid_attn, hybrid_local and
    ssm, fused and unfused, against `repro.core.blocks`;
  * teacher-forced logits at every prefill position and after decode
    steps, fused and unfused, against the reference `lm`, with the prefill
    caches (k / v, h, cx, cbc) held to the reference's;
  * the engine — exact-length prefill buckets, SSM state rows written at
    admission, recompute preemption — against the port's own direct
    prefill + decode loop (free-running engine tokens are never compared
    across frameworks: near-tied logits at random init make that no gate).

Reduced hymba has a sliding window of 8 under max_seq 128.  The
cache-free block prefill runs at window 8, where the window mask matters
(S = 13); the lm and engine tests here run hymba with the window widened
to max_seq (`sliding_window=cfg.max_seq`), the paged case the card serves
at max_seq 512 under hymba's window of 1024.  Its ring caches (a window
shorter than max_seq) are tested in test_torch_window.py.

Tolerances: fp32 rtol = atol = 1e-4 (the two sides differ in the order of
fp32 sums); bf16 KV pools 2e-2 (a pool row is one bf16 rounding); decode
logits over bf16 pools 1e-3 (a row rounded one ulp apart moves them by
~2e-4).
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
from repro.core.precision import FP32 as JFP32
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core import blocks as tblocks
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.kernels import ops as tops
from repro_torch.launch.steps import cache_layout, make_paged_layout
from repro_torch.models import lm as tlm
from repro_torch.models import params as tptree
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.kv_cache import prefill_scatter

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

ARCHS = ("hymba-1.5b", "mamba2-2.7b")
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
DECODE_LOGITS = dict(rtol=1e-3, atol=1e-3)
MAX_SEQ = 64
SSM_KEYS = ("h", "cx", "cbc")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _plan(fused):
    return UNSHARDED if fused else dataclasses.replace(UNSHARDED,
                                                       fuse_epilogues=False)


def _paged(cfg):
    """The reduced config with any window widened to max_seq: every
    attention layer's KV is paged (no ring cache)."""
    if not cfg.sliding_window:
        return cfg
    return dataclasses.replace(cfg, sliding_window=cfg.max_seq)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Reference weights with every norm scale perturbed off 1 (so the
    prologues and the gated norm matter), converted through numpy.
    -> (jcfg, tcfg, jparams, tparams) at the window-8 reduced config;
    `_paged` widens it."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray,
                        jlm.init_lm(jax.random.key(13), jcfg, jnp.float32))
    rng = np.random.default_rng(13)
    scales = [tree["final_norm"]]
    for seg in tree["segments"]:
        scales += [seg[k] for k in ("ln1", "ln2") if k in seg]
    for p in scales:
        p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)
                      ).astype(np.float32)
    for seg in tree["segments"]:
        s = seg["ssm"]["norm_scale"]
        seg["ssm"]["norm_scale"] = (1 + 0.1 * rng.standard_normal(s.shape)
                                    ).astype(np.float32)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            tlm.params_from_numpy(tree, tcfg, device="cpu"))


# --------------------------------------------------------------------------
# configs and weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.has_ssm and tcfg.ssm_heads == jcfg.ssm_heads
    assert tcfg.padded_ssm_heads() == jcfg.padded_ssm_heads()
    assert tcfg.padded_d_inner() == jcfg.padded_d_inner()
    assert reduced or tcfg.padded_ssm_heads() == {"hymba-1.5b": 64,
                                                  "mamba2-2.7b": 80}[arch]


def _shapes(tree, path=""):
    """{leaf path: shape} of a parameter tree (arrays, shape structs or the
    port's shape tuples as leaves)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_at_full_size(arch):
    """Every leaf of the reference's full-size tree (shapes from
    `jax.eval_shape`, nothing allocated) has the port's shape."""
    want = _shapes(jax.eval_shape(lambda: jlm.init_lm(jax.random.key(0),
                                                      jax_config(arch))))
    got = _shapes(tlm.lm_param_shapes(get_config(arch)))
    assert got == want
    if arch == "hymba-1.5b":
        assert got["/segments/0/ssm/w_x"] == (1, 1600, 4096)
        assert got["/segments/0/ssm/w_out"] == (1, 4096, 1600)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_ssm_tree(arch):
    jcfg, tcfg, jparams, tparams = _model(arch)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    tree = jax.tree.map(np.asarray, jparams)
    del tree["segments"][0]["ssm"]["conv_bc"]
    with pytest.raises(ValueError, match="conv_bc"):
        tlm.params_from_numpy(tree, tcfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["segments"][0]["ssm"]["w_out"] = tree["segments"][0]["ssm"][
        "w_out"][:, :8]
    with pytest.raises(ValueError, match="w_out"):
        tlm.params_from_numpy(tree, tcfg, device="cpu")


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

BLOCK_CASES = [("hymba-1.5b", 0, "hybrid_attn"),
               ("hymba-1.5b", 1, "hybrid_local"),
               ("mamba2-2.7b", 0, "ssm")]


def _layer_of(arch, seg, kind):
    jcfg, tcfg, jp, tp = _model(arch)
    assert jcfg.schedule[seg][0] == kind
    return (jax.tree.map(lambda a: a[0], jp["segments"][seg]),
            tptree.layer(tp["segments"][seg], 0))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[2])
def test_block_full_matches_reference(case, fused):
    """Cache-free prefill at the reduced window of 8 (S = 13: the window
    mask cuts the hybrid_local rows)."""
    arch, seg, kind = case
    jcfg, tcfg, _, _ = _model(arch)
    jlayer, tlayer = _layer_of(arch, seg, kind)
    x = np.random.default_rng(1).standard_normal((2, 13, 64)).astype(
        np.float32)
    jx, _, _ = jblocks.block_full(kind, jlayer, jnp.asarray(x),
                                  plan=_plan(fused), cfg=jcfg, policy=JFP32)
    tx, cache = tblocks.block_full(kind, tlayer, torch.tensor(x), cfg=tcfg,
                                   policy=FP32, fused=fused)
    assert cache is None
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: c[2])
def test_block_decode_matches_reference(case, fused):
    """One decode step: the updated stream, the pools after the append and
    the SSM state, all updated in place on the port's side."""
    arch, seg, kind = case
    jcfg, tcfg, _, _ = _model(arch)
    jcfg, tcfg = _paged(jcfg), _paged(tcfg)
    jlayer, tlayer = _layer_of(arch, seg, kind)
    rng = np.random.default_rng(3)
    B, NB, BS = 3, 9, 8
    Hp, P, N = tcfg.padded_ssm_heads(), tcfg.ssm_head_dim, tcfg.ssm_state
    state = {"h": rng.standard_normal((B, Hp, P, N)),
             "cx": rng.standard_normal((B, 3, Hp * P)),
             "cbc": rng.standard_normal((B, 3, 2 * N))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    jcache = {k: jnp.asarray(v) for k, v in state.items()}
    tcache = {k: torch.tensor(v) for k, v in state.items()}
    paged = kind != "ssm"
    tab = np.array([[2, 5, -1, -1], [0, 7, 1, -1], [4, 3, 6, 8]], np.int32)
    pos = np.array([12, 20, 31], np.int32)
    if paged:
        KV, hd = tcfg.n_kv_heads, tcfg.head_dim
        for key in ("k", "v"):
            pool = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
            jcache[key] = jnp.asarray(pool).astype(jnp.bfloat16)
            tcache[key] = torch.tensor(np.concatenate(
                [pool, np.zeros((1, BS, KV, hd), np.float32)])).bfloat16()
    x = rng.standard_normal((B, 64)).astype(np.float32)
    jy, jc = jblocks.block_decode(kind, jlayer, jnp.asarray(x),
                                  jnp.asarray(pos), jcache,
                                  plan=_plan(fused), cfg=jcfg, policy=JFP32,
                                  block_tables=jnp.asarray(tab), paged=paged)
    h_leaf = tcache["h"]
    ty, tc = tblocks.block_decode(kind, tlayer, torch.tensor(x),
                                  torch.tensor(pos), tcache, cfg=tcfg,
                                  policy=FP32, block_tables=torch.tensor(tab),
                                  fused=fused)
    np.testing.assert_allclose(_np(ty), _np(jy), **F32)
    assert tc["h"] is h_leaf                          # written in place
    for key in SSM_KEYS:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **F32)
    if paged:
        for key in ("k", "v"):
            np.testing.assert_array_equal(_np(tc[key][:NB]), _np(jc[key]))


# --------------------------------------------------------------------------
# the model, teacher-forced
# --------------------------------------------------------------------------

def _jax_logits(jcfg, jp, x, fused):
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    norm = jops.norm_prologue(jp["final_norm"], jcfg.norm)
    if not fused:
        xt, norm = jops.norm(xt, jp["final_norm"], jcfg.norm), None
    z, _ = jemb.logits_local(xt, jp["embedding"]["unemb"], plan=UNSHARDED,
                             cfg=jcfg, policy=JFP32, norm=norm)
    return z.reshape(B, S, -1)


def _torch_logits(tcfg, tp, x, fused):
    B, S, E = x.shape
    xt = x.reshape(B * S, E)
    norm = tops.norm_prologue(tp["final_norm"], tcfg.norm)
    if not fused:
        xt, norm = tops.norm(xt, tp["final_norm"], tcfg.norm), None
    z = temb.logits_local(xt, tp["embedding"]["unemb"], cfg=tcfg,
                          policy=FP32, norm=norm)
    return z.reshape(B, S, -1)


def _load_reference_caches(tcaches, jcaches, NB):
    """Start a decode step from the reference's caches (so the step, not
    the accumulated history, is what the comparison sees)."""
    for tseg, jseg in zip(tcaches, jcaches):
        for key, leaf in tseg.items():
            val = torch.tensor(np.asarray(jseg[key], np.float32))
            if key in ("k", "v"):
                leaf[:, :NB] = val.to(leaf.dtype)
            else:
                leaf.copy_(val)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_prefill_and_decode(arch, fused):
    jcfg, tcfg, jp, tp = _model(arch)
    jcfg, tcfg = _paged(jcfg), _paged(tcfg)
    rng = np.random.default_rng(5)
    B, S, BS, NB, n_dec = 2, 13, 8, 10, 3
    tokens = rng.integers(0, jcfg.vocab, (B, S + n_dec), dtype=np.int32)
    prompt = tokens[:, :S]

    jx = jlm._embed_sequence(jp, {"tokens": jnp.asarray(prompt)},
                             plan=UNSHARDED, cfg=jcfg, policy=JFP32,
                             with_labels=False)[0]
    jx, jcaches = jlm._run_segments_prefill(
        jp, jx, plan=_plan(fused), cfg=jcfg, policy=JFP32, max_seq=32,
        memory=None, memory_len=0, compact_kv=True)
    tx = tlm._embed_sequence(tp, torch.tensor(prompt), policy=FP32)
    tx, tcaches = tlm._run_segments_prefill(tp, tx, cfg=tcfg, policy=FP32,
                                            max_seq=32, fused=fused,
                                            compact_kv=True)
    np.testing.assert_allclose(_np(tx), _np(jx), **F32)
    np.testing.assert_allclose(_np(_torch_logits(tcfg, tp, tx, fused)),
                               _np(_jax_logits(jcfg, jp, jx, fused)), **F32)
    # the reference builds a window layer's prefill cache as a ring of
    # `window` rows even where the layer is paged (attention.py:172); with
    # window >= S its first S rows are the compact cache, in order
    jcaches = tuple({k: (v[:, :, :S] if k in ("k", "v") else v)
                     for k, v in seg.items()} for seg in jcaches)
    for tseg, jseg in zip(tcaches, jcaches):
        assert set(tseg) == set(jseg)
        for key in tseg:
            assert tuple(tseg[key].shape) == jseg[key].shape
            np.testing.assert_allclose(_np(tseg[key]), _np(jseg[key]),
                                       **(BF16 if key in "kv" else F32))

    paged = tuple(tblocks.kind_paged(k, tcfg, 32) for k, _ in tcfg.schedule)
    layout = make_paged_layout(tcfg, 32, num_blocks=NB, block_size=BS)
    assert layout.segments == paged
    tc = cache_layout(tcfg, layout, batch_size=B, policy=FP32, device="cpu")
    tables = np.full((B, layout.max_blocks), -1, np.int32)
    tables[0, :2] = [4, 1]
    tables[1, :2] = [0, 9]
    slots = np.array([1, 0], np.int32)
    prefill_scatter(tc, tcaches, torch.tensor(slots), torch.tensor(tables),
                    block_size=BS)
    jc = []
    for (kind, count), pg in zip(jcfg.schedule, paged):
        d = {}
        if pg:
            shape = (count, NB, BS, jcfg.n_kv_heads, jcfg.head_dim)
            d["k"] = jnp.zeros(shape, jnp.bfloat16)
            d["v"] = jnp.zeros(shape, jnp.bfloat16)
        for key in SSM_KEYS:
            leaf = tc[len(jc)][key]
            d[key] = jnp.zeros(tuple(leaf.shape), jnp.float32)
        jc.append(d)
    jc = make_prefill_scatter(paged, BS)(
        tuple(jc), jcaches, jnp.asarray(slots), jnp.asarray(tables))
    for tseg, jseg in zip(tc, jc):
        for key in tseg:
            got = tseg[key][:, :NB] if key in "kv" else tseg[key]
            np.testing.assert_allclose(_np(got), _np(jseg[key]),
                                       **(BF16 if key in "kv" else F32))

    # decode: slot b holds prompt row slots^-1[b]
    order = np.argsort(slots)
    dtab = tables[order]
    ttab, jtab = torch.tensor(dtab), jnp.asarray(dtab)
    for i in range(n_dec):
        _load_reference_caches(tc, jc, NB)
        pos = np.full((B,), S + i, np.int32)
        tok = tokens[order, S + i]
        jxd = jemb.embed_token(jp["embedding"]["embed"], jnp.asarray(tok),
                               plan=UNSHARDED, policy=JFP32)
        jxd, jc = jlm._run_segments_decode(
            jp, jxd, jnp.asarray(pos), jc, plan=_plan(fused), cfg=jcfg,
            policy=JFP32, memory_len=0, block_tables=jtab,
            paged_segments=paged)
        txd = temb.embed_token(tp["embedding"]["embed"], torch.tensor(tok),
                               policy=FP32)
        txd, tc = tlm._run_segments_decode(
            tp, txd, torch.tensor(pos), tc, cfg=tcfg, policy=FP32,
            block_tables=ttab, fused=fused)
        tol = DECODE_LOGITS if any(paged) else F32
        np.testing.assert_allclose(_np(txd), _np(jxd), **tol)
        np.testing.assert_allclose(
            _np(_torch_logits(tcfg, tp, txd[:, None], fused)),
            _np(_jax_logits(jcfg, jp, jxd[:, None], fused)), **tol)
        for tseg, jseg in zip(tc, jc):
            for key in SSM_KEYS:
                np.testing.assert_allclose(_np(tseg[key]), _np(jseg[key]),
                                           **tol)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def _direct(cfg, params, prompt, n_new, fused, block_size=16):
    """Unpadded prefill + greedy decode loop outside the engine ->
    (tokens, the prefill's compact caches)."""
    tok, caches, pos = tlm.forward_prefill(
        params, torch.tensor(np.asarray(prompt)[None]), cfg=cfg, policy=FP32,
        max_seq=MAX_SEQ, compact_kv=True, fused=fused)
    layout = make_paged_layout(cfg, MAX_SEQ, -(-MAX_SEQ // block_size),
                               block_size)
    state = cache_layout(cfg, layout, batch_size=1, policy=FP32,
                         device="cpu")
    table = torch.arange(layout.max_blocks, dtype=torch.int32)[None]
    prefill_scatter(state, caches, torch.arange(1), table,
                    block_size=block_size)
    toks = [int(tok[0])]
    for _ in range(n_new - 1):
        tok, state = tlm.forward_decode(params, tok, pos, state, cfg=cfg,
                                        policy=FP32, block_tables=table,
                                        fused=fused)
        pos = pos + 1
        toks.append(int(tok[0]))
    return toks, caches


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in lengths]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_exact_length_buckets_match_direct_loop(arch, fused):
    """Prompts prefill at their exact lengths (no pad position enters the
    state), one length per admission group; greedy tokens equal the direct
    loop's; no block leaks."""
    _, tcfg, _, tp = _model(arch)
    tcfg = _paged(tcfg)
    lengths = (5, 11, 7, 11)
    prompts = _prompts(tcfg, lengths, seed=3)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, fuse_epilogues=fused, device="cpu")
    assert [eng.runner.bucket_for(n) for n in (5, 9, 31)] == [5, 9, 31]
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
    done = sorted(eng.run(), key=lambda r: r.uid)
    st = eng.stats()
    assert sorted(st.bucket_hits) == sorted(set(lengths))
    assert st.padded_nar_tokens == st.nar_tokens == sum(lengths)
    for req in done:
        assert req.bucket == req.prompt_len
        assert _direct(tcfg, tp, req.prompt, 5, fused)[0] == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_writes_ssm_state_rows_at_admission(arch):
    """Two one-token requests admit into slots 0 and 1 and retire: each
    slot's h / cx / cbc rows hold its prompt's prefill state, slot 2 stays
    zero."""
    _, tcfg, _, tp = _model(arch)
    tcfg = _paged(tcfg)
    prompts = _prompts(tcfg, (9, 6), seed=4)
    eng = InferenceEngine(tcfg, tp, batch_size=3, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=1))
    eng.run()
    for slot, prompt in enumerate(prompts):
        _, caches = _direct(tcfg, tp, prompt, 1, True)
        for live, new in zip(eng.runner.caches, caches):
            for key in SSM_KEYS:
                np.testing.assert_allclose(_np(live[key][:, slot]),
                                           _np(new[key][:, 0]), **F32)
    for seg in eng.runner.caches:
        for key in SSM_KEYS:
            assert not seg[key][:, 2].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_preemption_recompute_matches_direct_loop(arch):
    """A 7-block pool of 4-token blocks cannot hold both slots' growth:
    recompute preemption re-prefills the evicted request's prompt and
    output, rebuilding its SSM state; tokens equal the direct loop's."""
    _, tcfg, _, tp = _model(arch)
    tcfg = _paged(tcfg)
    prompts = _prompts(tcfg, (9, 6, 10), seed=6)
    eng = InferenceEngine(tcfg, tp, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, block_size=4, kv_pool_blocks=7,
                          device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=8))
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert eng.stats().preemptions > 0
    for req in done:
        assert _direct(tcfg, tp, req.prompt, 8, True)[0] == req.output
    assert eng.allocator.num_free == eng.allocator.num_blocks

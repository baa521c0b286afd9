"""PyTorch port, token-tree speculative decoding on the CPU at reduced
widths:

  * against the JAX reference: `build_tree` and `accept_tree_path` on
    random trees; `attn_chunk_paged` with `rope_pos` / `tree_mask` (y and
    the pools within fp32 1e-4); `forward_verify_tree` greedy and sampled
    on a width-3 tree (choices equal, pools within fp32 1e-4), and on a
    lower-triangular single-branch tree, which must equal the port's
    `forward_verify` on the same chain bit for bit; `row_copy` against
    `make_row_copy`;
  * the port's tree engine: outputs token-identical to plain decoding in
    fp32, greedy and sampled, with the rejection-heavy draft and the
    mid-range one (a sibling branch accepted), branches 2 and 3, mixed
    with chunked prefill, a prefix-cache warm start and preemption; the
    pool drains; int8 KV pools force a single branch; branches=1 builds
    the chain engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.core.precision import FP32 as JFP32
from repro.models import lm as jlm
from repro.serving import spec as jspec
from repro.serving.kv_cache import make_row_copy
from repro.sharding.plan import UNSHARDED
from repro_torch.core import attention as tattn
from repro_torch.core.precision import FP32
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.serving import (ChunkedPrefillPolicy, InferenceEngine,
                                 SpecConfig)
from repro_torch.serving import spec as tspec
from repro_torch.serving.kv_cache import row_copy

from test_torch_chunk import _attn_case
from test_torch_spec import (F32, LANES, NB, drained, midrange_draft,
                             reduced, run, trace, verify_setup)

torch.set_num_threads(2)

REJECTY_TREE = SpecConfig(draft="auto", k=3, draft_seed=1234, branches=3)


# --------------------------------------------------------------------------
# topology and acceptance against the reference
# --------------------------------------------------------------------------

def _random_levels(rng):
    depth = int(rng.integers(0, 5))
    return [[int(t) for t in rng.integers(0, 6, int(rng.integers(1, 4)))]
            for _ in range(depth)]


def test_build_tree_and_accept_path_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(150):
        pending = int(rng.integers(0, 6))
        levels = _random_levels(rng)
        t, j = tspec.build_tree(pending, levels), jspec.build_tree(pending,
                                                                   levels)
        for f in ("tokens", "depth", "parent", "anc", "chain"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        choices = rng.integers(0, 6, t.n_nodes)
        assert tspec.accept_tree_path(t.tokens, t.parent, choices,
                                      t.n_nodes) \
            == jspec.accept_tree_path(j.tokens, j.parent, choices,
                                      j.n_nodes)
    chain = tspec.build_tree(7, [[3], [9], [4]])
    assert list(chain.depth) == [0, 1, 2, 3]
    assert np.array_equal(chain.anc, np.tril(np.ones((4, 4), bool)))
    ann = tspec.round_annotation(proposed=6, accepted=3, emitted=5,
                                 tree_nodes=7, path_depths=[2, 1],
                                 branch_hits=1)
    assert ann == jspec.round_annotation(proposed=6, accepted=3, emitted=5,
                                         tree_nodes=7, path_depths=[2, 1],
                                         branch_hits=1)


# --------------------------------------------------------------------------
# the tree chunk stack against the reference
# --------------------------------------------------------------------------

def _tree_ops(B, C, rng, width=3):
    """Per-row trees of `width` at depth (C - 1) // width (row 1 one depth
    shallower, its tail padded): tokens fill in by the caller; -> (depth
    [B, C], anc [B, C, C], chunk_len [B], trees)."""
    depth = np.zeros((B, C), np.int32)
    anc = np.zeros((B, C, C), bool)
    clen = np.zeros((B,), np.int32)
    trees = []
    for b in range(B):
        d = (C - 1) // width - b
        levels = [[int(t) for t in rng.integers(0, 50, width)]
                  for _ in range(d)]
        tree = tspec.build_tree(int(rng.integers(0, 50)), levels)
        n = tree.n_nodes
        depth[b, :n], anc[b, :n, :n], clen[b] = tree.depth, tree.anc, n
        trees.append(tree)
    return depth, anc, clen, trees


def test_attn_chunk_paged_tree_matches_reference():
    """`attn_chunk_paged` with a width-2 tree's rope_pos and ancestor
    mask: y at the real nodes and the pools within fp32 1e-4 of the
    reference's (KV still written at pos0 + node index, pads to the
    sink)."""
    cfg, jcfg, p, x, pos0, clen, tab, cache, NB_ = _attn_case("fp32", 5)
    B, C = x.shape[:2]
    rng = np.random.default_rng(9)
    depth, anc, clen, _ = _tree_ops(B, C, rng, width=2)
    rope_pos = pos0[:, None] + depth

    def run_ref(p, x, pos0, clen, cache, tab, rope_pos, anc):
        return jattn.attn_chunk_paged(p, x, pos0, clen, cache, tab,
                                      plan=UNSHARDED, cfg=jcfg,
                                      policy=JFP32, residual=x,
                                      rope_pos=rope_pos, tree_mask=anc)
    jy, jcache = jax.jit(run_ref)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(pos0), jnp.asarray(clen),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(tab),
        jnp.asarray(rope_pos), jnp.asarray(anc))
    tcache = {k: torch.from_numpy(np.concatenate([v, v[:1] * 0]))
              for k, v in cache.items()}
    tx = torch.from_numpy(x)
    y, _ = tattn.attn_chunk_paged(
        {k: torch.from_numpy(v) for k, v in p.items()}, tx,
        torch.from_numpy(pos0), torch.from_numpy(clen), tcache,
        torch.from_numpy(tab), cfg=cfg, policy=FP32, residual=tx,
        rope_pos=torch.from_numpy(rope_pos), tree_mask=torch.from_numpy(anc))
    real = np.arange(C)[None, :] < clen[:, None]
    np.testing.assert_allclose(y.numpy()[real], np.asarray(jy)[real], **F32)
    for k, v in jcache.items():
        np.testing.assert_allclose(tcache[k][:NB_].numpy(), np.asarray(v),
                                   **F32)


@pytest.mark.parametrize("lane", ["greedy", "sampled"])
def test_forward_verify_tree_matches_reference(lane):
    """A width-3 tree a row (depth 2 and 1) at each row's decode position:
    choices at the real nodes equal to the reference's, pools within fp32
    1e-4.  Then a lower-triangular single-branch tree on clones of the
    same pools: bit for bit `forward_verify` on that chain."""
    (jcfg, tcfg, jparams, tparams, caches, jcaches, table, pos0,
     rng) = verify_setup("gpt-j", seed=1)
    C = 7
    depth, anc, clen, trees = _tree_ops(2, C, rng)
    tokens = np.zeros((2, C), np.int32)
    for b, t in enumerate(trees):
        tokens[b, :t.n_nodes] = t.tokens
    ln = LANES[lane]
    chain_caches = tuple({k: v.clone() for k, v in seg.items()}
                         for seg in caches)
    verify_caches = tuple({k: v.clone() for k, v in seg.items()}
                          for seg in caches)
    jch, jc, _ = jlm.forward_verify_tree(
        jparams, jnp.asarray(tokens), jnp.asarray(pos0), jnp.asarray(clen),
        jnp.asarray(depth), jnp.asarray(anc), jcaches, jnp.asarray(table),
        plan=UNSHARDED, cfg=jcfg, policy=JFP32,
        lane={k: jnp.asarray(v) for k, v in ln.items()})
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    tch, out, tpos = tlm.forward_verify_tree(
        tparams, torch.from_numpy(tokens), torch.from_numpy(pos0),
        torch.from_numpy(clen), torch.from_numpy(depth),
        torch.from_numpy(anc), caches, torch.from_numpy(table), cfg=tcfg,
        policy=FP32, lane=tln)
    assert out is caches and tpos.tolist() == (pos0 + clen).tolist()
    real = np.arange(C)[None, :] < clen[:, None]
    np.testing.assert_array_equal(tch.numpy()[real], np.asarray(jch)[real])
    for seg_t, seg_j in zip(caches, jc):
        for k in seg_j:
            np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                       np.asarray(seg_j[k]), **F32)
    # the chain as a tree: depth == index, anc lower-triangular
    n = np.array([5, 3], np.int32)
    chain_tok = rng.integers(0, tcfg.vocab, (2, 5)).astype(np.int32)
    tri = np.broadcast_to(np.tril(np.ones((5, 5), bool)), (2, 5, 5)).copy()
    args = (torch.from_numpy(chain_tok), torch.from_numpy(pos0),
            torch.from_numpy(n))
    a, _, _ = tlm.forward_verify_tree(
        tparams, *args, torch.arange(5).repeat(2, 1), torch.from_numpy(tri),
        chain_caches, torch.from_numpy(table), cfg=tcfg, policy=FP32,
        lane=tln)
    b, _, _ = tlm.forward_verify(tparams, *args, verify_caches,
                                 torch.from_numpy(table), cfg=tcfg,
                                 policy=FP32, lane=tln)
    assert torch.equal(a, b)
    for seg_a, seg_b in zip(chain_caches, verify_caches):
        for k in seg_a:
            assert torch.equal(seg_a[k], seg_b[k])


def test_row_copy_matches_reference():
    """One position moved across every paged k / v pool, in place, bit
    equal to the reference's `make_row_copy`; the sink and other rows
    untouched."""
    rng = np.random.default_rng(4)
    count, NB_, BS_, KV, hd = 2, 6, 4, 2, 8
    pools = tuple({k: rng.standard_normal((count, NB_ + 1, BS_, KV, hd))
                   .astype(np.float32) for k in ("k", "v")}
                  for _ in range(2))
    live = tuple({k: torch.from_numpy(v.copy()) for k, v in seg.items()}
                 for seg in pools)
    ptrs = [{k: v.data_ptr() for k, v in seg.items()} for seg in live]
    jc = tuple({k: jnp.asarray(v[:, :NB_]) for k, v in seg.items()}
               for seg in pools)
    for src, dst in (((4, 3), (1, 0)), ((2, 1), (2, 0)), ((5, 2), (0, 3))):
        jc = make_row_copy((True, True))(jc, *src, *dst)
        row_copy(live, *src, *dst, (True, True))
    assert [{k: v.data_ptr() for k, v in seg.items()} for seg in live] \
        == ptrs
    for seg_t, seg_j, seg_0 in zip(live, jc, pools):
        for k in seg_j:
            np.testing.assert_array_equal(seg_t[k][:, :NB_].numpy(),
                                          np.asarray(seg_j[k]))
            np.testing.assert_array_equal(seg_t[k][:, NB_].numpy(),
                                          seg_0[k][:, NB_])


# --------------------------------------------------------------------------
# the port's tree engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_greedy_token_identity_tree(arch):
    cfg, params = reduced(arch)
    lens = (5, 12, 9)
    base = run(cfg, params, trace(cfg, lens))[1]
    eng, got = run(cfg, params, trace(cfg, lens), spec=REJECTY_TREE)
    st = eng.stats()
    assert got == base and drained(eng)
    assert eng.runner.tree_branches == 3
    assert st.spec_rounds > 0 and st.spec_tree_nodes > st.spec_slot_steps
    assert st.verify_positions == st.spec_tree_nodes


def test_sampled_lossless_parity_tree():
    cfg, params = reduced("gpt-j")
    lens = (6, 14, 10, 8)
    reqs = lambda: trace(cfg, lens, sampled=(0, 1, 3))
    base = run(cfg, params, reqs())[1]
    for b in (2, 3):
        eng, got = run(cfg, params, reqs(),
                       spec=SpecConfig(draft="auto", k=3, draft_seed=1234,
                                       branches=b))
        assert got == base and drained(eng), f"b={b}"


def test_midrange_tree_takes_a_sibling():
    """The mid-range draft as a tree (k 4, width 3): sibling branches win
    some rounds (their accepted rows compacted with row_copy), and the
    outputs stay plain decoding's, greedy and sampled."""
    cfg, params = reduced("gpt-j")
    reqs = lambda: trace(cfg, (5, 12, 9, 8), max_new=16, sampled=(1,))
    base = run(cfg, params, reqs())[1]
    eng, got = run(cfg, params, reqs(),
                   spec=SpecConfig(draft="auto", k=4, branches=3),
                   draft_params=midrange_draft(cfg, params))
    st = eng.stats()
    assert got == base and drained(eng)
    assert st.spec_branch_hits > 0 and st.spec_branch_utilization > 0
    assert st.spec_path_depth_p95 >= 1


def test_tree_with_chunked_prefill_prefix_cache_and_preemption():
    cfg, params = reduced("phi4-mini-3.8b")
    lens = (5, 40, 12, 33)
    base = run(cfg, params, trace(cfg, lens, sampled=(1,)))[1]
    eng, got = run(cfg, params, trace(cfg, lens, sampled=(1,)),
                   scheduler=ChunkedPrefillPolicy(16), prefix_cache=True,
                   spec=REJECTY_TREE)
    assert eng.stats().prefill_chunks >= 5 and got == base
    eng.prefix_cache.clear()
    assert drained(eng)
    lens = (5, 11, 7, 16)
    reqs = lambda: trace(cfg, lens, max_new=9, sampled=(1, 3))
    base = run(cfg, params, reqs())[1]
    eng, got = run(cfg, params, reqs(), spec=REJECTY_TREE, block_size=8,
                   kv_pool_blocks=5)
    assert eng.stats().preemptions > 0
    assert got == base and drained(eng)


def test_int8_kv_forces_chain_and_branches_one_is_chain():
    cfg, params = reduced("gpt-j")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=64, policy=FP32,
                          device="cpu", kv_dtype="int8",
                          spec=SpecConfig(draft="self", k=2, branches=3))
    r = eng.runner
    assert r.kv_dtype == "int8" and r.tree_branches == 1
    assert r.tree_verify_step is None and r.draft_topk_step is None
    lens = (5, 9)
    base = run(cfg, params, trace(cfg, lens), kv_dtype="int8")[1]
    for rq in trace(cfg, lens):
        eng.submit(rq)
    assert {t.uid: t.output for t in eng.run()} == base and drained(eng)
    eng1, got1 = run(cfg, params, trace(cfg, lens), spec=SpecConfig(
        draft="auto", k=3, draft_seed=1234))
    eng2, got2 = run(cfg, params, trace(cfg, lens), spec=SpecConfig(
        draft="auto", k=3, draft_seed=1234, branches=1))
    r2 = eng2.runner
    assert r2.tree_branches == 1 and r2.tree_verify_step is None
    assert r2.draft_topk_step is None and r2.draft_decode_step is not None
    assert got1 == got2
    assert eng2.stats().spec_tree_nodes == 0
    assert eng1.stats().to_dict()["spec_proposed_tokens"] \
        == eng2.stats().to_dict()["spec_proposed_tokens"]


def test_draft_topk_step_alts():
    """The tree draft's step: alts[:, 0] is the chain token it returns,
    and the alts equal `forward_decode_topk` run eagerly on clones."""
    cfg, params = reduced("gpt-j")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=32, policy=FP32,
                          device="cpu", spec=REJECTY_TREE)
    r = eng.runner
    clones = tuple({k: v.clone() for k, v in seg.items()}
                   for seg in r.draft_caches)
    tok, pos = np.array([3, 200], np.int32), np.array([0, 31], np.int32)
    out, alts, pos1, _ = r.draft_topk_step.fn(tok, pos, None, r.lane)
    want, want_alts, _ = tlm.forward_decode_topk(
        r.draft_params, torch.from_numpy(tok), torch.from_numpy(pos), clones,
        n=3, cfg=r.draft_cfg, policy=FP32,
        lane={k: torch.from_numpy(v) for k, v in r.lane.items()},
        block_tables=torch.zeros((2, 0), dtype=torch.int32),
        paged_segments=r.draft_layout.segments)
    assert torch.equal(alts[:, 0], out) and torch.equal(out, want)
    assert torch.equal(alts, want_alts) and pos1.tolist() == [1, 32]
    assert tsteps.make_dense_layout(r.draft_cfg, 32).max_seq == 32

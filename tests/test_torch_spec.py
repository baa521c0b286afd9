"""PyTorch port, speculative decoding (chain) on the CPU at reduced widths:

  * against the JAX reference, on inputs made from a seed with numpy and
    the reference's weights carried over with `params_from_numpy`:
    `spec_support_reason` word for word for every port config (full size
    and reduced), `make_draft` / the registered drafts field for field,
    `accept_length` / `trim_emitted` on random cases, `sample_topn` ids
    (greedy and sampled rows, exact ties, rows whose top-k keeps fewer
    than n ids), `forward_decode_topk` on the draft's dense linear caches,
    `forward_verify` (greedy and sampled: choices equal, pools within fp32
    1e-4) and the dense draft prefill scatter;
  * the lossless contract inside the port's engine (never engine tokens
    across frameworks): spec and plain outputs token-identical in fp32,
    greedy and sampled, with the "self", "auto" (rejection-heavy) and
    mid-range drafts, k 1 and 4, mixed with chunked prefill, a
    prefix-cache warm start, preemption under a tight pool, EOS inside an
    accepted prefix and the max_seq cap; the pool drains; the stats
    surface; acceptance="greedy" refuses sampled submissions; the draft
    step on the dense layout; the CLI flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import embedding as jemb
from repro.core.precision import FP32 as JFP32
import repro.launch.steps  # noqa: F401  (turns partitionable threefry on)
from repro.models import lm as jlm
from repro.serving import spec as jspec
from repro.serving.kv_cache import make_prefill_scatter
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import REGISTRY, get_config, make_draft
from repro_torch.core import embedding as temb
from repro_torch.core.precision import FP32
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.serving import (ChunkedPrefillPolicy, InferenceEngine,
                                 Request, SamplingParams, SpecConfig)
from repro_torch.serving import spec as tspec
from repro_torch.serving.kv_cache import prefill_scatter

torch.set_num_threads(2)

F32 = dict(rtol=1e-4, atol=1e-4)
# a draft seeded away from the target's init: its proposals are near
# random over the reduced vocabulary, so almost every round rejects (the
# rollback / draft-rewind regime)
REJECTY = SpecConfig(draft="auto", k=3, draft_seed=1234)


# --------------------------------------------------------------------------
# host-side pieces against the reference
# --------------------------------------------------------------------------

def test_spec_config_validation():
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpecConfig(k=0)
    with pytest.raises(ValueError, match="branch count"):
        SpecConfig(branches=0)
    with pytest.raises(ValueError, match="acceptance"):
        SpecConfig(acceptance="approximate")
    with pytest.raises(ValueError, match="draft"):
        SpecConfig(draft="")
    assert SpecConfig() == SpecConfig(draft="auto", k=4,
                                      acceptance="lossless", draft_seed=0,
                                      branches=1)


def test_accept_and_trim_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        k = int(rng.integers(0, 6))
        prop = list(rng.integers(0, 4, k))
        tgt = list(rng.integers(0, 4, k + 1))
        assert tspec.accept_length(prop, tgt) == jspec.accept_length(prop,
                                                                     tgt)
        em = [int(t) for t in rng.integers(0, 5, int(rng.integers(1, 6)))]
        room = int(rng.integers(0, 7))
        eos = None if rng.random() < 0.3 else int(rng.integers(0, 5))
        assert tspec.trim_emitted(list(em), room=room, eos_id=eos) \
            == jspec.trim_emitted(list(em), room=room, eos_id=eos)


def _support_cases():
    for name in sorted(REGISTRY):
        for reduced in (False, True):
            yield name, reduced


@pytest.mark.parametrize("name,reduced", list(_support_cases()))
def test_spec_support_reason_matches_reference(name, reduced):
    tcfg, jcfg = get_config(name), jax_config(name)
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    assert tspec.spec_support_reason(tcfg) == jspec.spec_support_reason(jcfg)


@pytest.mark.parametrize("target", ["gpt-j", "gpt3-xl", "phi4-mini-3.8b"])
def test_drafts_match_reference(target):
    """make_draft and the registered `<target>-draft` field for field;
    resolve_draft: "self", "auto", a named draft reduced beside a reduced
    target, and a vocabulary mismatch refused."""
    fields = lambda c: dataclasses.asdict(c)
    assert fields(make_draft(get_config(target))) \
        == fields(jax_config(target + "-draft"))
    assert fields(get_config(target + "-draft")) \
        == fields(jax_config(target + "-draft"))
    cfg = get_config(target).reduced()
    assert tspec.resolve_draft(SpecConfig(draft="self"), cfg) is cfg
    for draft in ("auto", target + "-draft"):
        assert fields(tspec.resolve_draft(SpecConfig(draft=draft), cfg)) \
            == fields(jspec.resolve_draft(jspec.SpecConfig(draft=draft),
                                          jax_config(target).reduced()))
    with pytest.raises(ValueError, match="tokenizer"):
        tspec.resolve_draft(SpecConfig(draft="gpt-j-draft"),
                            get_config("gpt3-xl"))


# --------------------------------------------------------------------------
# sample_topn / forward_decode_topk
# --------------------------------------------------------------------------

def _topn_case():
    """Integer-valued x and unemb, so every logit is exact in fp32 in both
    packages: exact ties arise (the top values repeat), greedy rows rank
    them by id.  Rows: greedy, greedy, sampled with top_k 40, sampled with
    top_k 2 (fewer kept ids than n: padding), sampled full vocabulary."""
    cfg = get_config("gpt-j").reduced()
    rng = np.random.default_rng(7)
    E, V = cfg.d_model, cfg.padded_vocab
    x = rng.integers(-2, 3, (5, E)).astype(np.float32)
    unemb = rng.integers(-1, 2, (E, V)).astype(np.float32)
    # row 0's largest logit, tied five ways (ids 7 and 40-43)
    unemb[:, 7] = np.sign(x[0])
    unemb[:, 40:44] = unemb[:, 7:8]
    lane = {"temperature": np.array([0, 0, 0.8, 1.3, 0.7], np.float32),
            "top_k": np.array([0, 5, 40, 2, 0], np.int32),
            "seed": np.array([3, 4, 5, 6, 7], np.int32),
            "step": np.array([9, 10, 11, 12, 13], np.int32)}
    return cfg, x, unemb, lane


@pytest.mark.parametrize("n", [1, 3, 6])
def test_sample_topn_matches_reference(n):
    cfg, x, unemb, lane = _topn_case()
    jtok, jalts = jemb.sample_topn(
        jnp.asarray(x), jnp.asarray(unemb),
        {k: jnp.asarray(v) for k, v in lane.items()}, n, plan=UNSHARDED,
        cfg=jax_config("gpt-j").reduced(), policy=JFP32)
    tlane = {k: torch.from_numpy(v) for k, v in lane.items()}
    ttok, talts = temb.sample_topn(torch.from_numpy(x),
                                   torch.from_numpy(unemb), tlane, n,
                                   cfg=cfg, policy=FP32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(talts.numpy(), np.asarray(jalts))
    assert talts.shape == (5, n) and talts.dtype == torch.int32
    # alts[:, 0] is sample_token's choice, bit for bit
    want = temb.sample_token(torch.from_numpy(x), torch.from_numpy(unemb),
                             tlane, cfg=cfg, policy=FP32)
    assert torch.equal(talts[:, 0], want)
    if n == 6:
        z = torch.from_numpy(x) @ torch.from_numpy(unemb)
        top = z[0].max()
        tied = torch.nonzero(z[0] == top).flatten()
        assert tied.tolist() == [7, 40, 41, 42, 43]
        assert talts[0, :5].tolist() == tied.tolist()


def _dense_inputs(cfg, B, max_seq, rng):
    """A random fp32 dense linear cache (the draft's layout) for every
    attention segment, as numpy [count, B, max_seq, KV, hd]."""
    return tuple({k: (rng.standard_normal((c, B, max_seq, cfg.n_kv_heads,
                                           cfg.head_dim)) * 0.5
                      ).astype(np.float32) for k in ("k", "v")}
                 for _, c in cfg.schedule)


def test_forward_decode_topk_matches_reference():
    """The tree draft's step on the dense layout's linear caches: tok and
    alts equal to the reference's, caches within fp32 1e-4 (the linear
    branch of the dense decode), greedy and sampled rows."""
    tcfg = make_draft(get_config("gpt-j").reduced())
    jcfg = jspec.resolve_draft(jspec.SpecConfig(draft="auto"),
                               jax_config("gpt-j").reduced())
    jparams = jlm.init_lm(jax.random.key(3), jcfg, jnp.float32)
    tparams = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    rng = np.random.default_rng(5)
    B, S = 3, 32
    caches = _dense_inputs(tcfg, B, S, rng)
    layout = tsteps.make_dense_layout(tcfg, S)
    tc = tsteps.cache_layout(tcfg, layout, batch_size=B, policy=FP32,
                             device="cpu")
    for seg, src in zip(tc, caches):
        assert seg["k"].shape == src["k"].shape
        for k in seg:
            seg[k].copy_(torch.from_numpy(src[k]))
    token = rng.integers(0, tcfg.vocab, B).astype(np.int32)
    pos = np.array([0, 17, S - 1], np.int32)
    lane = {"temperature": np.array([0, 0.9, 0.6], np.float32),
            "top_k": np.array([0, 8, 0], np.int32),
            "seed": np.array([1, 2, 3], np.int32)}
    jtok, jalts, jc = jlm.forward_decode_topk(
        jparams, jnp.asarray(token), jnp.asarray(pos),
        tuple({k: jnp.asarray(v) for k, v in s.items()} for s in caches),
        n=3, plan=UNSHARDED, cfg=jcfg, policy=JFP32,
        lane={k: jnp.asarray(v) for k, v in lane.items()})
    ttok, talts, out = tlm.forward_decode_topk(
        tparams, torch.from_numpy(token), torch.from_numpy(pos), tc, n=3,
        cfg=tcfg, policy=FP32,
        lane={k: torch.from_numpy(v) for k, v in lane.items()},
        block_tables=torch.zeros((B, 0), dtype=torch.int32),
        paged_segments=layout.segments)
    assert out is tc
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(talts.numpy(), np.asarray(jalts))
    for seg_t, seg_j in zip(tc, jc):
        for k in seg_j:
            np.testing.assert_allclose(seg_t[k].numpy(), np.asarray(seg_j[k]),
                                       **F32)


def test_dense_draft_prefill_scatter_matches_reference():
    """The draft's prefill lands a bucket-wide group (S < max_seq) in rows
    [0, S) of its slots' linear caches; the reference scatters the same
    group padded to max_seq rows.  The other slots are untouched."""
    cfg = make_draft(get_config("gpt-j").reduced())
    rng = np.random.default_rng(6)
    B, S, M = 4, 12, 32
    layout = tsteps.make_dense_layout(cfg, M)
    live = tsteps.cache_layout(cfg, layout, batch_size=B, policy=FP32,
                               device="cpu")
    before = _dense_inputs(cfg, B, M, rng)
    for seg, src in zip(live, before):
        for k in seg:
            seg[k].copy_(torch.from_numpy(src[k]))
    group = tuple({k: rng.standard_normal(
        (c, 2, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
        for k in ("k", "v")} for _, c in cfg.schedule)
    slots = np.array([3, 1], np.int32)
    padded = tuple({k: np.pad(v, ((0, 0), (0, 0), (0, M - S), (0, 0),
                                  (0, 0))) for k, v in g.items()}
                   for g in group)
    want = make_prefill_scatter((False,) * len(cfg.schedule), 1)(
        tuple({k: jnp.asarray(v) for k, v in s.items()} for s in before),
        tuple({k: jnp.asarray(v) for k, v in g.items()} for g in padded),
        jnp.asarray(slots), jnp.zeros((2, 1), jnp.int32))
    ptrs = [{k: v.data_ptr() for k, v in seg.items()} for seg in live]
    prefill_scatter(live, tuple({k: torch.from_numpy(v)
                                 for k, v in g.items()} for g in group),
                    torch.from_numpy(slots), None, block_size=1,
                    paged_segments=layout.segments)
    assert [{k: v.data_ptr() for k, v in seg.items()} for seg in live] \
        == ptrs
    for seg_t, seg_j, seg_0 in zip(live, want, before):
        for k in seg_j:
            got, ref = seg_t[k].numpy(), np.asarray(seg_j[k])
            np.testing.assert_array_equal(got[:, slots, :S],
                                          ref[:, slots, :S])
            np.testing.assert_array_equal(got[:, [0, 2]], ref[:, [0, 2]])
            # rows [S, M) of the written slots keep their old values (the
            # reference writes zeros there); the draft never reads them
            np.testing.assert_array_equal(got[:, slots, S:],
                                          seg_0[k][:, slots, S:])


# --------------------------------------------------------------------------
# forward_verify against the reference
# --------------------------------------------------------------------------

MAX_SEQ, BS, NB = 64, 8, 24


def verify_setup(arch, seed=0):
    """Reference and port params, paged pools with a 30- and a 19-token
    prefix already written (one chunk pass each), and the two rows' block
    tables."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = jlm.init_lm(jax.random.key(seed), jcfg, jnp.float32)
    tparams = tlm.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    device="cpu")
    layout = tsteps.make_paged_layout(tcfg, MAX_SEQ, NB, BS)
    caches = tsteps.cache_layout(tcfg, layout, batch_size=2, policy=FP32,
                                 device="cpu")
    table = np.full((2, layout.max_blocks), -1, np.int32)
    table[0, :6] = [3, 9, 1, 14, 20, 5]
    table[1, :4] = [0, 11, 7, 2]
    rng = np.random.default_rng(seed + 8)
    lens = np.array([30, 19], np.int32)
    tok = np.zeros((2, 32), np.int32)
    for b, n in enumerate(lens):
        tok[b, :n] = rng.integers(0, tcfg.vocab, n)
    tlm.forward_chunk(tparams, torch.from_numpy(tok), torch.zeros(2,
                      dtype=torch.int32), torch.from_numpy(lens), caches,
                      torch.from_numpy(table), cfg=tcfg, policy=FP32)
    jcaches = tuple({k: jnp.asarray(v[:, :NB].numpy())
                     for k, v in seg.items()} for seg in caches)
    return jcfg, tcfg, jparams, tparams, caches, jcaches, table, lens, rng


LANES = {"greedy": {"temperature": np.zeros(2, np.float32),
                    "top_k": np.zeros(2, np.int32),
                    "seed": np.zeros(2, np.int32)},
         "sampled": {"temperature": np.array([0.8, 1.1], np.float32),
                     "top_k": np.array([8, 0], np.int32),
                     "seed": np.array([11, 12], np.int32)}}


@pytest.mark.parametrize("lane", ["greedy", "sampled"])
@pytest.mark.parametrize("arch", ["gpt-j", "phi4-mini-3.8b"])
def test_forward_verify_matches_reference(arch, lane):
    """A k + 1 = 5 chunk at each row's decode position (row 1 carries 3
    real tokens, 2 pad): the target's choice at every real position equal
    to the reference's, the pools within fp32 1e-4 after the pass, and the
    choices equal to step-by-step `forward_decode` on copies of the pools
    (what the lossless contract rests on)."""
    (jcfg, tcfg, jparams, tparams, caches, jcaches, table, pos0,
     rng) = verify_setup(arch)
    C = 5
    tokens = rng.integers(0, tcfg.vocab, (2, C)).astype(np.int32)
    clen = np.array([5, 3], np.int32)
    ln = LANES[lane]
    decode_caches = tuple({k: v.clone() for k, v in seg.items()}
                          for seg in caches)
    jch, jc, jpos = jlm.forward_verify(
        jparams, jnp.asarray(tokens), jnp.asarray(pos0), jnp.asarray(clen),
        jcaches, jnp.asarray(table), plan=UNSHARDED, cfg=jcfg, policy=JFP32,
        lane={k: jnp.asarray(v) for k, v in ln.items()})
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    tch, out, tpos = tlm.forward_verify(
        tparams, torch.from_numpy(tokens), torch.from_numpy(pos0),
        torch.from_numpy(clen), caches, torch.from_numpy(table), cfg=tcfg,
        policy=FP32, lane=tln)
    assert out is caches
    real = np.arange(C)[None, :] < clen[:, None]
    np.testing.assert_array_equal(tch.numpy()[real], np.asarray(jch)[real])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for seg_t, seg_j in zip(caches, jc):
        for k in seg_j:
            np.testing.assert_allclose(seg_t[k][:, :NB].numpy(),
                                       np.asarray(seg_j[k]), **F32)
    tab = torch.from_numpy(table)
    for j in range(C):
        tok, _ = tlm.forward_decode(
            tparams, torch.from_numpy(tokens[:, j]),
            torch.from_numpy(pos0 + j), decode_caches, cfg=tcfg,
            policy=FP32, block_tables=tab, lane=tln)
        for b in range(2):
            if j < clen[b]:
                assert int(tok[b]) == int(tch[b, j])


# --------------------------------------------------------------------------
# the port's engine: the lossless contract
# --------------------------------------------------------------------------

_PARAMS = {}


def reduced(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch).reduced()
        _PARAMS[arch] = (cfg, tlm.init_lm(cfg, dtype=torch.float32,
                                          device="cpu", seed=0))
    return _PARAMS[arch]


def trace(cfg, lens, *, max_new=7, sampled=(), eos=None, prefix=None):
    rng = np.random.default_rng(29)
    reqs = []
    for uid, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab, n, dtype=np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        reqs.append(Request(
            uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=eos,
            sampling=(SamplingParams(temperature=0.8, top_k=8, seed=uid)
                      if uid in sampled else SamplingParams())))
    return reqs


def run(cfg, params, reqs, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_seq", 64)
    engine = InferenceEngine(cfg, params, policy=FP32, device="cpu", **kw)
    for r in reqs:
        engine.submit(r)
    return engine, {t.uid: t.output for t in engine.run()}


def midrange_draft(cfg, params, alpha=0.1, seed=1234):
    """The draft between the target and noise: the target's embedding,
    head, final norm and first DRAFT_LAYERS layers, mixed (1 - alpha)
    with alpha of a draft init at another seed.  Its top-1 is wrong often
    enough to reject while its runners-up still carry the target's choice:
    the regime where sibling branches win."""
    dcfg = tspec.resolve_draft(SpecConfig(draft="auto"), cfg)
    other = tlm.init_lm(dcfg, dtype=torch.float32, device="cpu", seed=seed)
    n = dcfg.n_layers

    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}

    def mix(a, b):
        if isinstance(a, dict):
            return {k: mix(a[k], b[k]) for k in a}
        if isinstance(a, tuple):
            return tuple(mix(x, y) for x, y in zip(a, b))
        return (1 - alpha) * a + alpha * b
    return mix({"embedding": params["embedding"],
                "final_norm": params["final_norm"],
                "segments": (cut(params["segments"][0]),)}, other)


def drained(engine):
    return engine.allocator.num_free == engine.allocator.num_blocks


@pytest.mark.parametrize("arch", ["gpt-j", "gpt3-xl", "phi4-mini-3.8b"])
def test_greedy_token_identity(arch):
    """Greedy outputs with speculation equal plain decoding's, under the
    all-accept draft ("self", k 1 and 4) and the rejection-heavy one."""
    cfg, params = reduced(arch)
    lens = (5, 12, 9)
    base = run(cfg, params, trace(cfg, lens))[1]
    for spec in (SpecConfig(draft="self", k=4), SpecConfig(draft="self",
                                                           k=1), REJECTY):
        eng, got = run(cfg, params, trace(cfg, lens), spec=spec)
        st = eng.stats()
        assert got == base, f"{arch} diverged under {spec}"
        assert st.spec_rounds > 0 and drained(eng)
        if spec.draft == "self":
            assert st.spec_acceptance_rate == 1.0
            assert 1.0 < st.spec_tokens_per_step <= spec.k + 1


def test_sampled_lossless_parity():
    """Sampled requests (fixed seeds) come out token for token: acceptance
    compares with the target's (seed, position)-keyed draws."""
    cfg, params = reduced("gpt-j")
    lens = (6, 14, 10, 8)
    reqs = lambda: trace(cfg, lens, sampled=(0, 1, 3))
    base = run(cfg, params, reqs())[1]
    for spec in (SpecConfig(draft="self", k=4), REJECTY):
        eng, got = run(cfg, params, reqs(), spec=spec)
        assert got == base and drained(eng)


def test_midrange_draft_accepts_partially():
    """The mid-range draft (alpha 0.1): identical outputs, greedy and
    sampled, with rounds that accept some proposals but not all."""
    cfg, params = reduced("gpt-j")
    reqs = lambda: trace(cfg, (5, 12, 9, 8), max_new=16, sampled=(1,))
    base = run(cfg, params, reqs())[1]
    eng, got = run(cfg, params, reqs(), spec=SpecConfig(draft="auto", k=4),
                   draft_params=midrange_draft(cfg, params))
    st = eng.stats()
    assert got == base and drained(eng)
    assert 0.0 < st.spec_acceptance_rate < 1.0
    assert 1.0 < st.spec_tokens_per_step < 5.0


def test_spec_with_chunked_prefill_and_prefix_cache():
    """Speculation beside ChunkedPrefillPolicy (long prompts chunk while
    seated slots speculate; the draft prefills whole when the last chunk
    lands) and beside the prefix cache (a warm start prefills the suffix
    only, the draft the whole prompt): outputs equal plain FCFS decoding
    without the cache; the pool drains (the cache's blocks apart)."""
    cfg, params = reduced("phi4-mini-3.8b")
    lens = (5, 40, 12, 33)
    base = run(cfg, params, trace(cfg, lens, sampled=(1,)))[1]
    eng, got = run(cfg, params, trace(cfg, lens, sampled=(1,)),
                   scheduler=ChunkedPrefillPolicy(16), spec=REJECTY)
    st = eng.stats()
    assert st.prefill_chunks >= 5 and st.spec_rounds > 0
    assert got == base and drained(eng)
    shared = np.random.default_rng(3).integers(0, cfg.vocab, 21,
                                               dtype=np.int32)
    reqs = lambda: trace(cfg, (4, 9, 6), prefix=shared, sampled=(2,))
    base = run(cfg, params, reqs())[1]
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=64, policy=FP32,
                          device="cpu", prefix_cache=True,
                          spec=SpecConfig(draft="self", k=3))
    first = reqs()
    eng.submit(first[0])
    while not first[0].output:
        eng.step()
    for r in first[1:]:
        eng.submit(r)
    got = {t.uid: t.output for t in eng.run()}
    st = eng.stats()
    assert got == base
    assert st.prefix_hits >= 2 and st.cached_prefix_tokens > 0
    assert st.spec_acceptance_rate == 1.0
    eng.prefix_cache.clear()
    assert drained(eng)


def test_preemption_then_resume_parity_with_spec():
    """Recompute preemption under a starved pool: evicted requests
    re-prefill (target and draft) and continue token for token; the
    lookahead's blocks never deadlock the pool."""
    cfg, params = reduced("phi4-mini-3.8b")
    lens = (5, 11, 7, 16)
    reqs = lambda: trace(cfg, lens, max_new=9, sampled=(1, 3))
    base = run(cfg, params, reqs())[1]
    eng, got = run(cfg, params, reqs(), spec=REJECTY, block_size=8,
                   kv_pool_blocks=5)
    assert eng.stats().preemptions > 0
    assert got == base and drained(eng)


def test_eos_inside_accepted_prefix_and_max_seq_cap():
    """An EOS inside an all-accept round ends the sequence where plain
    decoding stops; the max_seq horizon caps the lookahead."""
    cfg, params = reduced("gpt-j")
    base = run(cfg, params, trace(cfg, (6,), max_new=9))[1]
    eos = base[0][2]
    want = run(cfg, params, trace(cfg, (6,), max_new=9, eos=eos))[1]
    _, got = run(cfg, params, trace(cfg, (6,), max_new=9, eos=eos),
                 spec=SpecConfig(draft="self", k=4))
    assert got == want
    assert want[0][-1] == eos and len(want[0]) < 9
    reqs = lambda: trace(cfg, (6, 6), max_new=200)
    base = run(cfg, params, reqs(), max_seq=32)[1]
    eng, got = run(cfg, params, reqs(), max_seq=32,
                   spec=SpecConfig(draft="self", k=4))
    assert got == base and all(len(v) < 200 for v in base.values())
    assert drained(eng)


def test_unsupported_and_greedy_acceptance():
    cfg = get_config("gemma3-27b").reduced()     # ring caches
    params = tlm.init_lm(cfg, dtype=torch.float32, device="cpu", seed=1)
    with pytest.raises(ValueError, match="unsupported"):
        InferenceEngine(cfg, params, batch_size=2, max_seq=64, policy=FP32,
                        device="cpu", spec=SpecConfig(draft="auto"))
    cfg, params = reduced("phi4-mini-3.8b")
    engine = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                             policy=FP32, device="cpu",
                             spec=SpecConfig(draft="self", k=2,
                                             acceptance="greedy"))
    engine.submit(Request(uid=0, prompt=np.zeros(4, np.int32)))
    with pytest.raises(ValueError, match="greedy"):
        engine.submit(Request(uid=1, prompt=np.zeros(4, np.int32),
                              sampling=SamplingParams(temperature=0.7)))


def test_spec_stats_and_draft_state():
    cfg, params = reduced("gpt-j")
    eng, done = run(cfg, params, trace(cfg, (5, 9), max_new=8),
                    spec=SpecConfig(draft="self", k=3))
    st = eng.stats()
    assert st.spec_rounds > 0 and st.decode_steps == st.spec_rounds
    assert st.spec_emitted_tokens == st.ar_tokens
    assert 1.0 <= st.spec_tokens_per_step <= 4.0
    assert st.verify_positions >= st.spec_emitted_tokens
    assert st.draft_time_ms_p95 >= st.draft_time_ms_p50 > 0
    assert st.spec_draft_time_s > 0 and st.spec_tree_nodes == 0
    d = st.to_dict()
    for key in ("spec_acceptance_rate", "spec_tokens_per_step",
                "draft_time_ms_p50", "draft_time_ms_p95", "spec_rounds",
                "verify_positions", "spec_branch_utilization",
                "spec_path_depth_p50"):
        assert key in d
    assert "SPEC" in st.summary()
    assert all(s is None for s in eng.runner.draft_states)
    assert eng.runner.verify_step.aux["calls"] == st.spec_rounds


def test_draft_step_dense_layout():
    """The draft's caches follow the reference's `paged=None` layout:
    linear [count, B, max_seq, KV, hd] caches, no table; its decode step
    equals an eager `forward_decode` on clones of them."""
    cfg, params = reduced("gpt-j")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=48, policy=FP32,
                          device="cpu", spec=SpecConfig(draft="auto", k=2))
    r = eng.runner
    dcfg = r.draft_cfg
    assert r.draft_layout.max_blocks == 0 and not any(r.draft_layout.segments)
    assert r.draft_caches[0]["k"].shape == (2, 2, 48, dcfg.n_kv_heads,
                                            dcfg.head_dim)
    rng = np.random.default_rng(1)
    for seg in r.draft_caches:
        for v in seg.values():
            v.copy_(torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                     .astype(np.float32)))
    clones = tuple({k: v.clone() for k, v in seg.items()}
                   for seg in r.draft_caches)
    tok, pos = np.array([5, 9], np.int32), np.array([3, 47], np.int32)
    out, pos1, _ = r.draft_decode_step.fn(tok, pos, None, r.lane)
    want, _ = tlm.forward_decode(
        r.draft_params, torch.from_numpy(tok), torch.from_numpy(pos), clones,
        cfg=dcfg, policy=FP32, block_tables=torch.zeros((2, 0),
                                                        dtype=torch.int32),
        lane={k: torch.from_numpy(v) for k, v in r.lane.items()},
        paged_segments=r.draft_layout.segments)
    assert torch.equal(out, want) and pos1.tolist() == [4, 48]
    for seg, seg_c in zip(r.draft_caches, clones):
        for k in seg:
            assert torch.equal(seg[k], seg_c[k])


def test_serve_cli_spec(capsys):
    assert serve.main(["--arch", "gpt-j", "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch", "2", "--prompt-len",
                       "12", "--min-prompt-len", "4", "--max-new", "5",
                       "--temperature", "0.7", "--top-k", "20",
                       "--spec-draft", "auto", "--spec-k", "2",
                       "--spec-branches", "2"]) == 0
    out = capsys.readouterr().out
    assert "| SPEC" in out
    assert "spec: draft=gpt-j-reduced-draft k=2" in out
    assert "tree: b=2" in out

"""PyTorch port, the prefix cache, chunked prefill and the scheduler
policies on the CPU (fp32, reduced widths).

  * the block allocator's refcounts and reclaim hook and the radix index
    (`PrefixCache`: lookup / insert / LRU eviction / hash collisions /
    caps), the reference's unit cases, one parametrised case each;
  * engine tokens, port against port (free-running tokens are not compared
    across frameworks): a warm pass through the cache equals a cold
    engine's, greedy and sampled; chunked prefill equals whole-prompt
    prefill; preemption under a starved pool re-admits warm; a hit ending
    inside a block copies the shared tail on write; a prompt one short of
    a block boundary indexes only KV that has landed; cache-aware
    admission order; hymba, mamba2 and gemma3 refuse both features with
    the reference's reason and serve whole prompts;
  * the stats fields and summary; no pool or scale tensor is rebound by a
    chunk pass, a copy-on-write or a reclaim (the captured decode step
    holds their addresses), and a copy moves an int8 block's scales with
    it;
  * the scheduler: priority aging and its victim, `make_policy` names;
  * the CLI's `--policy`, `--prefill-chunk`, `--prefix-cache` /
    `--no-prefix-cache` and `--cache-blocks`.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as jsteps
from repro.sharding.plan import UNSHARDED
from repro_torch.configs import get_config
from repro_torch.core.precision import FP32
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import (ChunkedPrefillPolicy, FCFSPolicy,
                                 InferenceEngine, PrefixCache,
                                 PriorityPolicy, Request, SamplingParams,
                                 make_policy)
from repro_torch.serving import prefix_cache as pcm
from repro_torch.serving import runner as runner_mod
from repro_torch.serving.kv_cache import BlockAllocator, block_copy

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)


# --------------------------------------------------------------------------
# allocator refcounts and the radix index (host only)
# --------------------------------------------------------------------------

def _cache(num_blocks=16, bs=4, **kw):
    a = BlockAllocator(num_blocks=num_blocks, block_size=bs)
    return a, PrefixCache(a, bs, **kw)


def _allocator_retain_release(_):
    a = BlockAllocator(num_blocks=4, block_size=2)
    x = a.alloc(2)
    assert [a.refcount(b) for b in x] == [1, 1]
    a.retain(x)
    assert [a.refcount(b) for b in x] == [2, 2]
    a.free(x)                       # drops to 1: still allocated
    assert a.num_used == 2
    a.free(x)                       # drops to 0: back on the free list
    assert a.num_used == 0
    with pytest.raises(RuntimeError, match="double free"):
        a.free(x)


def _allocator_retain_unallocated_raises(_):
    a = BlockAllocator(num_blocks=2, block_size=2)
    with pytest.raises(RuntimeError, match="retain"):
        a.retain([0])
    with pytest.raises(ValueError):
        a.alloc(-1)
    with pytest.raises(ValueError):
        BlockAllocator(num_blocks=0, block_size=2)


def _allocator_reclaim_hook(_):
    """alloc() asks the reclaim hook before failing, and takes only what
    the hook freed."""
    a = BlockAllocator(num_blocks=4, block_size=2)
    held = a.alloc(4)
    calls = []

    def reclaim(shortfall):
        calls.append(shortfall)
        give = held[:min(shortfall, 2)]
        del held[:len(give)]
        a.free(give)
        return len(give)

    a.reclaim = reclaim
    got = a.alloc(2)                # hook frees 2 -> satisfied
    assert got is not None and calls == [2]
    assert a.alloc(3) is None       # hook frees 2, still short of 3
    assert calls[-1] == 3


def _lookup_insert_longest_prefix(_):
    a, pc = _cache()
    blk = a.alloc(3)
    toks = list(range(1, 12))           # 11 tokens: 2 full blocks + tail(3)
    pc.insert(toks, blk)
    pc.check()
    assert pc.cached_blocks == 3
    got, n = pc.lookup(toks)
    assert n == 11 and got == blk
    q = toks[:5] + [99] * 6             # diverges inside the second block
    got, n = pc.lookup(q)
    assert n == 5 and got[0] == blk[0] and len(got) == 2
    assert got[1] == blk[1]
    assert pc.lookup([99, 98, 97])[1] == 0
    got, n = pc.lookup(toks, limit=6)
    assert n == 6 and len(got) == 2


def _lookup_partial_of_full_block(_):
    """A full-block child matched only partway is still a hit."""
    a, pc = _cache()
    blk = a.alloc(2)
    pc.insert(list(range(8)), blk)
    got, n = pc.lookup([0, 1, 2, 3, 4, 5, 70, 71])
    assert n == 6 and got == blk


def _insert_dedup_first_writer_wins(_):
    a, pc = _cache()
    b1, b2 = a.alloc(2), a.alloc(2)
    toks = list(range(7))
    pc.insert(toks, b1)
    pc.insert(toks, b2)                 # same content: no new nodes
    pc.check()
    assert pc.cached_blocks == 2
    assert pc.lookup(toks)[0] == b1
    assert a.refcount(b2[0]) == 1       # duplicate content not retained


def _hash_collision_reads_as_miss(monkeypatch):
    """With every hash forced to collide, distinct contents still index
    and resolve apart, and eviction unlinks the right node."""
    monkeypatch.setattr(pcm, "_rhash", lambda toks, h=0: 7)
    a, pc = _cache()
    b1, b2 = a.alloc(2), a.alloc(2)
    t1 = list(range(7))
    t2 = [50 + t for t in range(7)]
    pc.insert(t1, b1)
    pc.insert(t2, b2)
    pc.check()
    assert pc.cached_blocks == 4
    assert pc.lookup(t1) == (b1, 7)
    assert pc.lookup(t2) == (b2, 7)
    assert pc.lookup([99, 98, 97])[1] == 0
    a.free(b1), a.free(b2)              # index-only now
    assert pc.clear() == 4
    pc.check()
    assert pc.cached_blocks == 0 and a.num_used == 0


def _lru_eviction_order_and_reclaim(_):
    a, pc = _cache(num_blocks=6, bs=4)
    b1, b2 = a.alloc(1), a.alloc(1)
    pc.insert([1, 2, 3, 4], b1)
    pc.insert([5, 6, 7, 8], b2)
    a.free(b1)
    a.free(b2)
    pc.lookup([1, 2, 3, 4])             # touch b1: b2 is the LRU
    got = a.alloc(5)                    # 4 free + 1 via reclaim
    assert got is not None
    pc.check()
    assert pc.cached_blocks == 1 and pc.evicted_blocks == 1
    assert pc.lookup([5, 6, 7, 8], record=False)[1] == 0
    assert pc.lookup([1, 2, 3, 4], record=False)[1] == 4


def _eviction_skips_pinned_blocks(_):
    a, pc = _cache(num_blocks=2, bs=4)
    b1 = a.alloc(1)
    pc.insert([1, 2, 3, 4], b1)         # refcount 2: caller + index
    assert a.alloc(2) is None
    a.free(b1)
    assert a.alloc(2) is not None
    assert pc.cached_blocks == 0


def _max_blocks_cap(_):
    a, pc = _cache(num_blocks=16, bs=4, max_blocks=2)
    for i in range(4):
        b = a.alloc(1)
        pc.insert([10 * i + j for j in range(4)], b)
        a.free(b)
        pc.check()
    assert pc.cached_blocks <= 2
    assert pc.evicted_blocks >= 2


def _cache_parameter_validation(_):
    a = BlockAllocator(num_blocks=4, block_size=4)
    with pytest.raises(ValueError, match="max_blocks"):
        PrefixCache(a, 4, max_blocks=-1)
    pc = PrefixCache(a, 4)
    with pytest.raises(ValueError, match="cannot cover"):
        pc.insert(list(range(9)), a.alloc(1))


UNIT_CASES = [_allocator_retain_release, _allocator_retain_unallocated_raises,
              _allocator_reclaim_hook, _lookup_insert_longest_prefix,
              _lookup_partial_of_full_block, _insert_dedup_first_writer_wins,
              _hash_collision_reads_as_miss, _lru_eviction_order_and_reclaim,
              _eviction_skips_pinned_blocks, _max_blocks_cap,
              _cache_parameter_validation]


@pytest.mark.parametrize("case", UNIT_CASES, ids=lambda f: f.__name__[1:])
def test_allocator_and_radix_index(case, monkeypatch):
    case(monkeypatch)


# --------------------------------------------------------------------------
# engine tokens, port against port
# --------------------------------------------------------------------------

_PARAMS = {}


def _reduced(arch):
    if arch not in _PARAMS:
        cfg = get_config(arch).reduced()
        _PARAMS[arch] = (cfg, tlm.init_lm(cfg, dtype=torch.float32,
                                          device="cpu", seed=0))
    return _PARAMS[arch]


def _shared_trace(cfg, n=4, *, uid0=0, pre_len=40, max_new=6, sampled=(),
                  seed=7):
    """n requests sharing a `pre_len`-token prefix, each with its own tail
    (request 0: the prefix alone).  Request i samples with seed i, so a
    copy with shifted uids draws the same tokens."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, pre_len, dtype=np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, cfg.vocab, 4 + i, dtype=np.int32)
        reqs.append(Request(
            uid=uid0 + i,
            prompt=np.concatenate([shared, tail]) if i else shared.copy(),
            max_new_tokens=max_new,
            sampling=SamplingParams(temperature=0.8, top_k=8, seed=i)
            if i in sampled else SamplingParams()))
    return reqs


def _engine(cfg, params, **kw):
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_seq", 64)
    return InferenceEngine(cfg, params, policy=FP32, device="cpu", **kw)


def _run(cfg, params, reqs, **kw):
    engine = _engine(cfg, params, **kw)
    for r in reqs:
        engine.submit(r)
    return engine, {t.uid: t.output for t in engine.run()}


def _resubmit(engine, reqs, uid0=100):
    for r in reqs:
        engine.submit(r)
    return {t.uid - uid0: t.output for t in engine.run()}


def _drained(engine):
    """A drained engine's only live blocks are the index's."""
    alloc, pc = engine.allocator, engine.prefix_cache
    assert alloc.num_free == alloc.num_blocks - pc.cached_blocks
    assert all(alloc.refcount(b) == 1 for b in pc.index_blocks())
    pc.check()


@pytest.mark.parametrize("arch", ["gpt-j", "gpt3-xl", "phi4-mini-3.8b"])
def test_warm_identity_greedy_and_sampled(arch):
    """A warmed cache serves every request as a cold engine does,
    encoding strictly fewer prompt tokens."""
    cfg, params = _reduced(arch)
    mk = lambda uid0: _shared_trace(cfg, uid0=uid0, sampled=(1, 3))
    base = _run(cfg, params, mk(0))[1]
    eng, got1 = _run(cfg, params, mk(0), prefix_cache=True,
                     kv_pool_blocks=24)
    assert got1 == base
    cold_nar = eng.stats().nar_tokens
    eng.reset_stats()
    assert _resubmit(eng, mk(100)) == base
    st = eng.stats()
    assert st.prefix_hits == 4 and st.prefix_cache_hit_rate == 1.0
    assert st.cached_prefix_tokens > 0 and st.prefill_chunks >= 4
    assert st.nar_tokens < cold_nar
    _drained(eng)


def test_in_batch_sharing_first_pass():
    """Prefix blocks are indexed when a prompt's KV lands, so later
    requests of the same trace already hit."""
    cfg, params = _reduced("phi4-mini-3.8b")
    base = _run(cfg, params, _shared_trace(cfg))[1]
    eng, got = _run(cfg, params, _shared_trace(cfg), prefix_cache=True,
                    kv_pool_blocks=24)
    assert got == base
    st = eng.stats()
    assert st.prefix_hits >= 2 and st.cached_prefix_tokens >= 80
    _drained(eng)


@pytest.mark.parametrize("arch,chunk", [("gpt-j", 8), ("gpt-j", 16),
                                        ("phi4-mini-3.8b", 16)])
def test_chunked_prefill_matches_whole_prompt(arch, chunk):
    """ChunkedPrefillPolicy: prompts over the budget prefill a piece a
    step between decode steps, with the tokens of whole-prompt prefill;
    the parked slots decode nothing until their last piece lands."""
    cfg, params = _reduced(arch)
    rng = np.random.default_rng(9)
    mk = lambda: [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab, n, dtype=np.int32), max_new_tokens=5,
        sampling=SamplingParams(temperature=0.7, top_k=10, seed=i)
        if i % 2 else SamplingParams())
        for i, n in enumerate((41, 6, 30, 17, 12))]
    reqs = mk()
    base = _run(cfg, params, [Request(uid=r.uid, prompt=r.prompt.copy(),
                                      max_new_tokens=5, sampling=r.sampling)
                              for r in reqs])[1]
    eng, got = _run(cfg, params, reqs, batch_size=3,
                    scheduler=ChunkedPrefillPolicy(chunk))
    assert got == base
    st = eng.stats()
    long = sum(-(-len(r.prompt) // chunk) for r in reqs
               if len(r.prompt) > chunk)
    assert st.prefill_chunks == long
    assert st.chunked_prefill_tokens == sum(len(r.prompt) for r in reqs
                                            if len(r.prompt) > chunk)
    assert len(st.decode_stall_ms) > 0 and st.decode_stall_p95_ms >= 0
    assert eng.allocator.num_free == eng.allocator.num_blocks


def test_preemption_recompute_warm_identity():
    """A starved pool with the cache on: preempted requests re-admit as
    hits and still finish as a cold engine does; nothing leaks."""
    cfg, params = _reduced("phi4-mini-3.8b")
    mk = lambda: _shared_trace(cfg, pre_len=20, max_new=9, sampled=(1, 3))
    base = _run(cfg, params, mk())[1]
    eng, got = _run(cfg, params, mk(), prefix_cache=True, block_size=8,
                    kv_pool_blocks=6)
    assert eng.stats().preemptions > 0
    assert got == base
    _drained(eng)


def test_cow_on_shared_partial_tail():
    """A hit ending inside a block copies the shared tail before the
    suffix writes into it, and the sharer decodes as a cold engine."""
    cfg, params = _reduced("gpt-j")
    rng = np.random.default_rng(3)
    p = rng.integers(0, cfg.vocab, 18, dtype=np.int32)     # 18 = 16 + 2
    eng, done = _run(cfg, params, [Request(uid=0, prompt=p.copy(),
                                           max_new_tokens=6)],
                     prefix_cache=True, block_size=16, kv_pool_blocks=16)
    p2 = np.concatenate([p, np.asarray(done[0][:2], np.int32)])
    base = _run(cfg, params, [Request(uid=1, prompt=p2.copy(),
                                      max_new_tokens=6)])[1]
    eng.submit(Request(uid=1, prompt=p2, max_new_tokens=6))
    got = {t.uid: t.output for t in eng.run()}
    st = eng.stats()
    assert got[1] == base[1]
    assert st.cow_copies >= 1 and st.cached_prefix_tokens >= 18
    _drained(eng)


def test_boundary_prompt_indexes_only_landed_kv():
    """A prompt of 2 * 16 - 1 tokens: after its prefill the index may hold
    the first block only (position 31, the sampled token, has no KV yet);
    after retirement the boundary block has landed and a prompt through
    it hits and decodes as a cold engine."""
    cfg, params = _reduced("gpt-j")
    rng = np.random.default_rng(5)
    p = rng.integers(0, cfg.vocab, 31, dtype=np.int32)
    eng = _engine(cfg, params, block_size=16, kv_pool_blocks=16,
                  prefix_cache=True)
    eng.submit(Request(uid=0, prompt=p.copy(), max_new_tokens=6))
    eng.step()
    out = eng.runner.slots[0].output
    _, matched = eng.prefix_cache.lookup(
        np.concatenate([p, np.asarray(out, np.int32)]), touch=False,
        record=False)
    assert len(out) >= 1 and matched <= 16
    done = {t.uid: t.output for t in eng.run()}
    p2 = np.concatenate([p, np.asarray(done[0][:2], np.int32)])
    base = _run(cfg, params, [Request(uid=1, prompt=p2.copy(),
                                      max_new_tokens=6)])[1]
    eng.submit(Request(uid=1, prompt=p2, max_new_tokens=6))
    assert {t.uid: t.output for t in eng.run()}[1] == base[1]
    assert eng.stats().cached_prefix_tokens >= 31
    _drained(eng)


def test_chunked_policy_warm_identity():
    """Cache + ChunkedPrefillPolicy: a long uncached suffix parks with
    prefilled = hit and the per-step budget finishes it."""
    cfg, params = _reduced("phi4-mini-3.8b")
    mk = lambda uid0: _shared_trace(cfg, uid0=uid0, sampled=(2,))
    base = _run(cfg, params, mk(0))[1]
    eng, got1 = _run(cfg, params, mk(0), prefix_cache=True,
                     kv_pool_blocks=24, scheduler=ChunkedPrefillPolicy(16))
    assert got1 == base
    assert _resubmit(eng, mk(100)) == base
    assert eng.stats().prefix_hits >= 4
    _drained(eng)


def test_cache_aware_admission_order():
    """With cache_aware on, a mostly cached request jumps a cold one
    (stable among equal cached lengths); off, arrival order holds."""
    cfg, params = _reduced("gpt-j")
    rng = np.random.default_rng(11)
    warm_p = rng.integers(0, cfg.vocab, 32, dtype=np.int32)
    cold_p = rng.integers(0, cfg.vocab, 32, dtype=np.int32)
    for aware in (True, False):
        eng, _ = _run(cfg, params, [Request(uid=0, prompt=warm_p.copy(),
                                            max_new_tokens=4)],
                      prefix_cache=True, batch_size=1, kv_pool_blocks=12,
                      scheduler=make_policy("fcfs", cache_aware=aware))
        cold = Request(uid=1, prompt=cold_p.copy(), max_new_tokens=4)
        warm = Request(uid=2, prompt=warm_p.copy(), max_new_tokens=4)
        eng.submit(cold)
        eng.submit(warm)
        eng.run()
        assert (warm._seq < cold._seq) == aware


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-2.7b",
                                  "gemma3-27b"])
def test_unsupported_arch_refuses_with_reason(arch):
    """Neither feature runs where the KV is not all paged: the runner
    states the reference's reason, and the engine serves whole prompts."""
    cfg, params = _reduced(arch)
    eng = _engine(cfg, params, prefix_cache=True,
                  scheduler=ChunkedPrefillPolicy(8))
    jcfg = jax_config(arch).reduced()
    want = jsteps.chunk_support_reason(
        jcfg, jsteps.make_paged_layout(jcfg, UNSHARDED, 64,
                                       eng.runner.layout.num_blocks, 16))
    assert want is not None
    assert eng.prefix_cache is None and not eng.runner.supports_chunked
    assert eng.runner.prefix_cache_reason == want
    assert eng.runner.chunk_unsupported_reason == want
    for r in _shared_trace(cfg, 2, pre_len=12, max_new=3):
        eng.submit(r)
    assert len(eng.run()) == 2
    st = eng.stats()
    assert st.prefill_chunks == 0 and st.prefix_lookups == 0
    with pytest.raises(ValueError, match="unsupported"):
        eng.runner.begin_chunked(Request(uid=9, prompt=np.ones(3, np.int32)),
                                 [], 0)


def test_stats_fields_and_summary():
    cfg, params = _reduced("gpt-j")
    eng, _ = _run(cfg, params, _shared_trace(cfg), prefix_cache=True,
                  kv_pool_blocks=24, scheduler=ChunkedPrefillPolicy(16))
    st = eng.stats()
    d = st.to_dict()
    for key in ("prefix_lookups", "prefix_hits", "prefix_cache_hit_rate",
                "cached_prefix_tokens", "cached_blocks", "evicted_blocks",
                "cow_copies", "prefill_chunks", "chunked_prefill_tokens",
                "decode_stall_p50_ms", "decode_stall_p95_ms",
                "decode_stall_p99_ms", "blocks_per_token", "kv_block_size"):
        assert key in d
    assert st.prefix_lookups >= st.prefix_hits > 0
    assert 0.0 < st.prefix_cache_hit_rate <= 1.0
    assert st.block_slot_steps > 0 and st.token_slot_steps > 0
    assert st.blocks_per_token == pytest.approx(
        st.block_slot_steps * 16 / st.token_slot_steps)
    text = st.summary()
    assert "PREFIX" in text and "chunked" in text and "decode-stall" in text
    eng.reset_stats()
    st2 = eng.stats()
    assert st2.prefix_lookups == 0 and st2.cached_prefix_tokens == 0
    assert st2.cached_blocks == eng.prefix_cache.cached_blocks
    assert st2.prefill_chunks == 0 and len(st2.decode_stall_ms) == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_pools_never_rebound(kv_dtype, monkeypatch):
    """Chunk passes, copy-on-write copies and reclaims write the pools
    and scales in place; a copy carries an int8 block's scales."""
    cfg, params = _reduced("gpt-j")
    eng = _engine(cfg, params, block_size=8, kv_pool_blocks=14,
                  prefix_cache=True, kv_dtype=kv_dtype,
                  scheduler=ChunkedPrefillPolicy(8))
    r = eng.runner
    leaves = [t for seg in r.caches for t in seg.values()]
    ptrs = [t.data_ptr() for t in leaves]
    copies = []

    def spy(caches, src, dst, segments):
        out = block_copy(caches, src, dst, segments)
        copies.append((src, dst))
        for seg in caches:
            for k, t in seg.items():
                assert torch.equal(t[:, dst], t[:, src]), k
        return out
    monkeypatch.setattr(runner_mod, "block_copy", spy)
    # warm hits ending mid-block (copy on write), pressure on a small pool
    # (reclaim), chunked pieces
    for req in _shared_trace(cfg, 4, pre_len=21, max_new=5, sampled=(1,)):
        eng.submit(req)
    eng.run()
    eng.prefix_cache.clear()
    for req in _shared_trace(cfg, 3, uid0=10, pre_len=21, max_new=5):
        eng.submit(req)
    eng.run()
    st = eng.stats()
    assert copies and st.cow_copies == len(copies)
    assert st.prefill_chunks > 0 and st.evicted_blocks > 0
    assert [t.data_ptr() for t in leaves] == ptrs
    assert all(t is u for t, u in zip(
        leaves, [t for seg in r.caches for t in seg.values()]))
    _drained(eng)


# --------------------------------------------------------------------------
# scheduler policies
# --------------------------------------------------------------------------

def _task(uid, priority=0, age=0.0, seq=0, deadline_ms=None):
    t = Request(uid=uid, prompt=np.ones(3, np.int32), priority=priority,
                deadline_ms=deadline_ms)
    t._t_submit = 100.0 - age
    t._seq = seq
    return t


def test_priority_aging_and_victim():
    pol = PriorityPolicy()
    assert pol.aging_s == 10.0 and pol.deadline_boost == 1.0
    old_low = _task(0, priority=0, age=25.0, seq=0)
    new_high = _task(1, priority=2, age=0.0, seq=1)
    mid = _task(2, priority=1, age=0.0, seq=2)
    # 0 + 25 / 10 = 2.5 outranks a fresh 2: aging bounds the inversion
    assert pol.admission_order([new_high, mid, old_low], 100.0) == [
        old_low, new_high, mid]
    assert pol.select_victim([old_low, new_high, mid], 100.0) is mid
    # equal effective priority: the youngest admitted is the victim, and
    # admission keeps arrival order
    a, b = _task(3, seq=5), _task(4, seq=9)
    assert pol.select_victim([a, b], 100.0) is b
    assert pol.admission_order([b, a], 100.0) == [b, a]
    # a deadline adds urgency up to deadline_boost
    late = _task(5, priority=0, age=1.0, deadline_ms=1000.0)
    assert pol.effective_priority(late, 100.0) == pytest.approx(1.1)
    # past its deadline the boost saturates at deadline_boost
    overdue = _task(6, priority=0, age=5.0, deadline_ms=1000.0)
    assert pol.effective_priority(overdue, 100.0) == pytest.approx(1.5)
    assert late.age_s(100.0) == pytest.approx(1.0)
    assert _task(7, age=-1.0).age_s(100.0) == 0.0


def test_make_policy_names():
    assert isinstance(make_policy("fcfs"), FCFSPolicy)
    assert isinstance(make_policy("priority"), PriorityPolicy)
    ch = make_policy("chunked", chunk_tokens=24, cache_aware=True)
    assert isinstance(ch, ChunkedPrefillPolicy)
    assert ch.chunk_tokens == 24 and ch.cache_aware
    assert ch.effective_chunk_tokens(0) == 24
    assert make_policy("chunked").chunk_tokens == 32
    assert make_policy("fcfs").effective_chunk_tokens(0) is None
    dl = make_policy("deadline", chunk_tokens=24)
    assert dl.name == "deadline" and dl.chunk_tokens == 24
    assert dl.effective_chunk_tokens(1) == 12
    with pytest.raises(KeyError, match="unknown policy"):
        make_policy("lifo")
    with pytest.raises(ValueError):
        ChunkedPrefillPolicy(0)


# --------------------------------------------------------------------------
# the CLI's flags
# --------------------------------------------------------------------------

BASE = ["--reduced", "--device", "cpu", "--requests", "4", "--batch", "2",
        "--prompt-len", "40", "--min-prompt-len", "10", "--max-new", "4",
        "--max-seq", "64", "--seed", "5"]
CHUNKED = (["--policy", "chunked", "--prefill-chunk", "8"],
           dict(policy="chunked", prefill_chunk=8, prefix_cache=True,
                cache_blocks=0), "chunks, decode-stall")
CLI_CASES = {
    "chunked": ("gpt-j",) + CHUNKED,
    "chunked-gpt3-xl": ("gpt3-xl",) + CHUNKED,
    "chunked-phi4": ("phi4-mini-3.8b",) + CHUNKED,
    "priority": ("gpt-j", ["--policy", "priority", "--no-prefix-cache"],
                 dict(policy="priority", prefix_cache=False),
                 "policy=priority"),
    "cache-blocks": ("gpt-j", ["--cache-blocks", "3"],
                     dict(policy="fcfs", prefix_cache=True, cache_blocks=3),
                     "PREFIX"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_serve_cli_policy_and_prefix_flags(case, capsys):
    arch, argv, want, marker = CLI_CASES[case]
    argv = ["--arch", arch] + BASE + argv
    args = serve.parser().parse_args(argv)
    for k, v in want.items():
        assert getattr(args, k) == v, k
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and marker in out
    eng, done, _ = serve.run(args)
    assert (eng.prefix_cache is not None) == args.prefix_cache
    assert eng.scheduler.name == args.policy
    if args.prefix_cache:
        assert eng.scheduler.cache_aware
        assert eng.prefix_cache.max_blocks == (args.cache_blocks or None)
    # the same trace through a plain FCFS engine: the same tokens
    cfg = get_config(arch).reduced()
    plain = InferenceEngine(cfg, tlm.init_lm(cfg, dtype=torch.bfloat16,
                                             device="cpu", seed=5),
                            batch_size=2, max_seq=64, device="cpu")
    for t in serve.build_trace(cfg, args):
        plain.submit(t)
    want_tok = {t.uid: t.output for t in plain.run()}
    assert {t.uid: t.output for t in done} == want_tok


def test_serve_cli_notes_configs_that_cannot_chunk(capsys):
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "12",
            "--max-new", "3", "--max-seq", "32", "--policy", "chunked"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "cannot chunk prefills" in out
    assert "prefix cache disabled for mamba2-2.7b" in out
    assert "served 2 requests" in out

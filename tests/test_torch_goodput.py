"""PyTorch port, the goodput engine on the CPU: the open-loop load
generator, DeadlinePolicy, the analytic FLOP model, and the overlapped host
loop.

Held to the reference (pure functions, the same inputs):
  * `make_trace` with the same LoadSpec and seeds gives the same trace
    (arrival times, uids, kinds, prompt tokens, sampling, budgets), and
    the specs refuse what the reference's refuse;
  * DeadlinePolicy's admission order, victim, shed candidates, degrade
    level and chunk budget on the same tasks at a fixed `now`;
  * `decoder_flops_per_token` / `model_flops` for every registry entry,
    within 1e-12 relative.
Held to the port itself (engine tokens are never compared across the two
frameworks), reduced phi4-mini and GPT-J in fp32:
  * the overlapped loop is token-identical to the synchronous one, greedy
    and sampled, under chunked prefill, with a warm prefix cache and with
    speculation (which never pipelines), and its fast path engages;
  * a chained dispatch uploads nothing and equals a loaded one bit for
    bit; shedding is typed and counted; degraded speculation is lossless;
    SLO accounting; `replay` runs open-loop end to end; `encode_batch=`.
"""
import math

import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.configs import REGISTRY as JREGISTRY
from repro.configs.base import ShapeConfig as JShape
from repro.serving import loadgen as jload
from repro.serving import scheduler as jsched
from repro.serving.tasks import GenerateTask as JTask
from repro_torch.analysis import roofline as troof
from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.precision import FP32
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.serving import (ArrivalSpec, ChunkedPrefillPolicy,
                                 DeadlinePolicy, EncodeTask, InferenceEngine,
                                 LoadSpec, PromptSpec, Rejection, Request,
                                 SamplingParams, SLOSpec, SpecConfig,
                                 arrival_times, make_policy, make_trace,
                                 replay)
from repro_torch.serving.tasks import GenerateTask, validate_task

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

MAX_SEQ = 64


# --------------------------------------------------------------------------
# the load generator against the reference
# --------------------------------------------------------------------------

MIXED = dict(prompts=dict(min_len=8, max_len=64, tail_alpha=1.5,
                          shared_frac=0.3, prefix_len=8, encode_frac=0.2,
                          sampled_frac=0.5),
             slo=dict(ttft_ms=250.0, tpot_ms=50.0))
TRACES = {
    "mixed": (400, dict(), MIXED, (7, 3, 100)),
    "bursty": (300, dict(kind="bursty", rate_rps=5.0, dwell_s=0.5),
               dict(prompts=dict(min_len=4, max_len=24)), (0, 0, 0)),
    "poisson-uniform": (200, dict(rate_rps=40.0),
                        dict(prompts=dict(min_len=3, max_len=30,
                                          sampled_frac=0.0),
                             slo=dict(ttft_ms=80.0), max_new=5,
                             eos_id=7), (11, 11, 5)),
}


def _specs(case):
    n, arrival, rest, _ = TRACES[case]
    kw = dict(rest)
    prompts, slo = kw.pop("prompts", {}), kw.pop("slo", {})
    both = []
    for mod in (jload, None):
        A = mod.ArrivalSpec if mod else ArrivalSpec
        P = mod.PromptSpec if mod else PromptSpec
        S = mod.SLOSpec if mod else SLOSpec
        L = mod.LoadSpec if mod else LoadSpec
        both.append(L(requests=n, vocab=1000, arrival=A(**arrival),
                      prompts=P(**prompts), slo=S(**slo), **kw))
    return both


def _fingerprint(trace):
    out = []
    for tt in trace:
        t = tt.task
        sp = getattr(t, "sampling", None)
        out.append((tt.t_s, t.uid, type(t).__name__, t.prompt.tolist(),
                    t.prompt.dtype.str, t.deadline_ms,
                    getattr(t, "slo_tpot_ms", None),
                    getattr(t, "max_new_tokens", None),
                    getattr(t, "eos_id", None),
                    None if sp is None else (sp.temperature, sp.top_k,
                                             sp.seed)))
    return out


@pytest.mark.parametrize("case", list(TRACES))
def test_make_trace_matches_reference(case):
    jspec, tspec = _specs(case)
    a_seed, p_seed, uid0 = TRACES[case][3]
    want = jload.make_trace(jspec, arrival_seed=a_seed, prompt_seed=p_seed,
                            uid0=uid0)
    got = make_trace(tspec, arrival_seed=a_seed, prompt_seed=p_seed,
                     uid0=uid0)
    assert _fingerprint(got) == _fingerprint(want)
    assert [tt.task.uid for tt in got] == list(range(uid0, uid0 + len(got)))


def test_arrival_times_match_reference():
    for kind in ("poisson", "bursty"):
        spec = ArrivalSpec(kind=kind, rate_rps=5.0, dwell_s=0.5)
        jspec = jload.ArrivalSpec(kind=kind, rate_rps=5.0, dwell_s=0.5)
        np.testing.assert_array_equal(
            arrival_times(spec, 500, np.random.default_rng(4)),
            jload.arrival_times(jspec, 500, np.random.default_rng(4)))
    assert ArrivalSpec(rate_rps=3.0).hi_rate == 12.0


def test_seeds_are_independent_axes():
    """The traffic seed moves only the clock; the prompt seed only the
    content; a sampled request's seed is its uid."""
    spec = _specs("mixed")[1]
    a = make_trace(spec, arrival_seed=0, prompt_seed=5)
    b = make_trace(spec, arrival_seed=99, prompt_seed=5)
    c = make_trace(spec, arrival_seed=0, prompt_seed=6)
    assert [x.t_s for x in a] != [x.t_s for x in b]
    assert [x.t_s for x in a] == [x.t_s for x in c]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.task.prompt, y.task.prompt)
        if isinstance(x.task, GenerateTask) and x.task.sampling.temperature:
            assert x.task.sampling.seed == x.task.uid


BAD_SPECS = [
    ("ArrivalSpec", dict(kind="lumpy")), ("ArrivalSpec", dict(rate_rps=0.0)),
    ("ArrivalSpec", dict(kind="bursty", dwell_s=0.0)),
    ("PromptSpec", dict(min_len=0)),
    ("PromptSpec", dict(min_len=4, shared_frac=0.5, prefix_len=0)),
    ("PromptSpec", dict(sampled_frac=1.5)),
    ("PromptSpec", dict(min_len=4, max_len=8, prefix_len=6)),
    ("LoadSpec", dict(requests=0, vocab=100)),
    ("LoadSpec", dict(requests=1, vocab=1)),
]


@pytest.mark.parametrize("name,kw", BAD_SPECS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(BAD_SPECS)])
def test_spec_validation_matches_reference(name, kw):
    import repro_torch.serving.loadgen as tload
    with pytest.raises(ValueError) as want:
        getattr(jload, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tload, name)(**kw)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# DeadlinePolicy against the reference
# --------------------------------------------------------------------------

NOW = 1000.0


def _pair(specs):
    """specs: (uid, deadline_ms or None, age_s, seq, has_output) -> the
    same tasks in both packages."""
    out = ([], [])
    for uid, dl, age, seq, has_out in specs:
        for cls, lst in ((JTask, out[0]), (GenerateTask, out[1])):
            t = cls(uid=uid, prompt=np.zeros((4,), np.int32), deadline_ms=dl)
            t._t_submit = NOW - age
            t._seq = seq
            if has_out:
                t.output.append(42)
            lst.append(t)
    return out


def _random_specs(seed, n=12):
    rng = np.random.default_rng(seed)
    specs = []
    for uid in range(n):
        dl = None if rng.random() < 0.25 else float(rng.choice(
            [50.0, 100.0, 250.0, 500.0]))
        specs.append((uid, dl, float(rng.choice([0.0, 0.04, 0.1, 0.3, 0.6])),
                      int(rng.permutation(n)[uid]), bool(rng.random() < 0.2)))
    return specs


POLICY_KW = [dict(), dict(chunk_tokens=32, ttft_floor_ms=60.0),
             dict(chunk_tokens=12, shed=False, degrade_depth=0.0),
             dict(chunk_tokens=9, degrade_depth=1.5)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", range(len(POLICY_KW)))
def test_deadline_policy_matches_reference(seed, kw):
    jt, tt = _pair(_random_specs(seed))
    jp = jsched.DeadlinePolicy(**POLICY_KW[kw])
    tp = DeadlinePolicy(**POLICY_KW[kw])
    uids = lambda ts: [t.uid for t in ts]
    assert uids(tp.admission_order(tt, NOW)) == uids(
        jp.admission_order(jt, NOW))
    assert tp.select_victim(tt, NOW).uid == jp.select_victim(jt, NOW).uid
    assert uids(tp.shed_candidates(tt, NOW)) == uids(
        jp.shed_candidates(jt, NOW))
    for n_queued in range(0, 20):
        for slots in (1, 2, 4):
            assert tp.degrade_level(n_queued, slots) == jp.degrade_level(
                n_queued, slots)
    for level in (0, 1, 2):
        assert tp.effective_chunk_tokens(level) == \
            jp.effective_chunk_tokens(level)
    for a, b in zip(tt, jt):
        assert a.slack_ms(NOW) == b.slack_ms(NOW)
        assert tp.admission_annotation(a, NOW) == \
            jp.admission_annotation(b, NOW)


def test_policy_defaults_match_reference():
    """The base class's goodput hooks and the other policies' annotations
    are the reference's."""
    jt, tt = _pair(_random_specs(3))
    for name in ("fcfs", "priority", "chunked", "deadline"):
        jp = jsched.make_policy(name, chunk_tokens=24)
        tp = make_policy(name, chunk_tokens=24)
        assert type(tp).__name__ == type(jp).__name__
        assert [t.uid for t in tp.shed_candidates(tt, NOW)] == [
            t.uid for t in jp.shed_candidates(jt, NOW)]
        assert tp.degrade_level(9, 2) == jp.degrade_level(9, 2)
        assert tp.effective_chunk_tokens(1) == jp.effective_chunk_tokens(1)
        for a, b in zip(tt, jt):
            ann, want = (tp.admission_annotation(a, NOW),
                         jp.admission_annotation(b, NOW))
            assert ann.keys() == want.keys()
            for k in ann:
                assert ann[k] == pytest.approx(want[k], rel=1e-12)


def test_task_slo_validation_and_slack():
    t = GenerateTask(uid=0, prompt=np.zeros((4,), np.int32),
                     deadline_ms=100.0, slo_tpot_ms=20.0)
    assert t.slack_ms(t._t_submit) == 100.0
    assert GenerateTask(uid=1, prompt=np.zeros((4,), np.int32)).slack_ms() \
        == math.inf
    t.prompt_len, t.prefilled = 4, 2
    t.output.append(3)
    assert t.remaining_prefill() == 3
    assert not t.degraded and t.rejection is None
    for bad in (0.0, -5.0, math.nan, math.inf):
        with pytest.raises(ValueError, match="deadline_ms"):
            GenerateTask(uid=0, prompt=np.zeros((4,), np.int32),
                         deadline_ms=bad)
    r = Rejection("slo_unattainable", "why")
    with pytest.raises(AttributeError):
        r.kind = "x"
    t.deadline_ms = -1.0
    with pytest.raises(ValueError, match="deadline_ms"):
        validate_task(t)


# --------------------------------------------------------------------------
# the analytic FLOP model against the reference
# --------------------------------------------------------------------------

SHAPES = (("train_4k", "train", 4096, 256), ("prefill_8", "prefill", 512, 8),
          ("decode_4", "decode", 512, 4))


@pytest.mark.parametrize("name", sorted(JREGISTRY))
def test_flops_match_reference(name):
    jcfg = JREGISTRY[name]
    for cfg_j, cfg_t in ((jcfg, REGISTRY[name]),
                         (jcfg.reduced(), get_config(name).reduced())):
        try:
            want = jroof.decoder_flops_per_token(cfg_j)
        except Exception as e:               # where it raises, so does the port
            with pytest.raises(type(e)):
                troof.decoder_flops_per_token(cfg_t)
            continue
        got = troof.decoder_flops_per_token(cfg_t)
        assert got == pytest.approx(want, rel=1e-12, abs=0)
        assert cfg_t.n_active_params() == cfg_j.n_active_params()
        for shape in SHAPES:
            assert troof.model_flops(cfg_t, ShapeConfig(*shape)) == \
                pytest.approx(jroof.model_flops(cfg_j, JShape(*shape)),
                              rel=1e-12, abs=0)


def test_utilization_and_h100_constants():
    # the H100 SXM data sheet's dense bf16 and HBM3 rates
    assert troof.PEAK_BF16 == 989e12 and troof.HBM_BW == 3.35e12
    for args in ((1e12, 2e9, 0.5), (3.0, 4.0, 0.0), (5e15, 7e11, 1e-3)):
        kw = dict(peak_flops=2e14, hbm_bw=8e11)
        assert troof.utilization(*args, **kw) == pytest.approx(
            jroof.utilization(*args, **kw), rel=1e-12)
    assert troof.utilization(989e12, 3.35e12, 1.0) == (1.0, 1.0)


# --------------------------------------------------------------------------
# the engine, port against port
# --------------------------------------------------------------------------

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = get_config(arch).reduced()
        _MODELS[arch] = (cfg, tlm.init_lm(cfg, dtype=torch.float32,
                                          device="cpu", seed=0))
    return _MODELS[arch]


def _reqs(cfg, lens, *, max_new=6, uid0=0, **kw):
    rng = np.random.default_rng(31)
    out = []
    for i, n in enumerate(lens):
        uid = uid0 + i
        out.append(Request(
            uid=uid, prompt=rng.integers(0, cfg.vocab, n, dtype=np.int32),
            max_new_tokens=max_new,
            sampling=SamplingParams(temperature=0.8, top_k=20, seed=uid)
            if uid % 2 else SamplingParams(), **kw))
    return out


def _run(cfg, params, reqs, **kw):
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu", **kw)
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    return eng, {t.uid: list(t.output) for t in done}


def _waves(cfg, params, **kw):
    """Two waves of four requests sharing an 18-token prefix through one
    engine with the prefix cache: the second wave admits warm."""
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab, 18, dtype=np.int32)
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu", prefix_cache=True,
                          kv_pool_blocks=16, **kw)
    out = {}
    for uid0 in (0, 100):
        for i in range(4):
            tail = np.full((3 + i,), (7 * i + 3) % cfg.vocab, np.int32)
            eng.submit(Request(
                uid=uid0 + i, prompt=np.concatenate([prefix, tail]),
                max_new_tokens=5,
                sampling=SamplingParams(temperature=0.8, top_k=20, seed=i)
                if i % 2 else SamplingParams()))
        out.update({t.uid: list(t.output) for t in eng.run()})
    return eng, out


MODES = ("plain", "chunked", "warm_prefix", "spec")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gpt-j"])
def test_overlap_token_identical_to_sync(arch, mode):
    """The overlapped loop dispatches step N + 1 before fetching step N's
    tokens; greedy and sampled outputs equal the synchronous loop's, the
    fast path engages (speculation stands it down: it never pipelines)."""
    cfg, params = _model(arch)
    if mode == "warm_prefix":
        _, sync = _waves(cfg, params)
        eng, ovl = _waves(cfg, params, overlap=True)
        assert eng.stats().prefix_cache_hit_rate > 0
    else:
        lens = {"chunked": [25, 11, 40, 9, 33, 6]}.get(
            mode, [5, 11, 20, 9, 14, 6])
        kw = {"chunked": dict(scheduler=ChunkedPrefillPolicy(16)),
              "spec": dict(spec=SpecConfig(draft="self", k=3))}.get(mode, {})
        _, sync = _run(cfg, params, _reqs(cfg, lens), **kw)
        eng, ovl = _run(cfg, params, _reqs(cfg, lens), overlap=True, **kw)
    assert ovl == sync
    st = eng.stats()
    if mode == "spec":
        assert st.spec_rounds > 0 and st.overlapped_steps == 0
        assert eng.fast_dispatches == 0
    else:
        assert st.overlapped_steps == st.decode_steps > 0
        assert eng.fast_dispatches > 0
        assert 0 < st.host_overlap_ratio <= 1.0
        assert st.to_dict()["host_overlap_ratio"] == st.host_overlap_ratio
    assert eng.allocator.num_free + (
        eng.prefix_cache.cached_blocks if eng.prefix_cache else 0) \
        == eng.allocator.num_blocks


def test_chained_dispatch_uploads_nothing(monkeypatch):
    """Once the engine runs, a steady-state step chains its token and pos
    on the previous step's outputs: no tensor made from host data, no
    `DecodeStep.load`.  The run's tokens still equal the synchronous
    loop's."""
    cfg, params = _model("gpt-j")
    lens = (3, 4)

    def reqs():
        return _reqs(cfg, lens, max_new=12)
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu", overlap=True)
    for r in reqs():
        eng.submit(r)
    for _ in range(3):
        eng.step()
    assert eng._pending is not None and eng._fast_dispatch_ok()
    step = eng.runner.decode_step.fn

    def refuse(*args, **kwargs):
        raise AssertionError("host data reached the device")
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(step, "load", refuse)
    before = eng.fast_dispatches
    for _ in range(4):
        eng.step()
    assert eng.fast_dispatches == before + 4
    monkeypatch.undo()
    got = {t.uid: t.output for t in eng.run()}
    _, want = _run(cfg, params, reqs())
    assert {u: want[u] for u in got} == got


def test_chained_replay_equals_loaded_replay():
    """One chained dispatch against one fed the same values through
    `load()`, from the same caches: next tokens, pos + 1 and every cache
    leaf bit-equal."""
    cfg, params = _model("phi4-mini-3.8b")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu")
    for r in _reqs(cfg, (6, 9), max_new=8):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    r = eng.runner
    step = r.decode_step.fn
    assert step.chainable
    token, pos = step.out[0].numpy().copy(), step.out[1].numpy().copy()
    saved = [{k: v.clone() for k, v in seg.items()} for seg in r.caches]
    chained = step.dispatch(None, None, None, None, chained=True).wait()
    out_c = step.out.clone()
    caches_c = [{k: v.clone() for k, v in seg.items()} for seg in r.caches]
    for seg, seg_s in zip(r.caches, saved):
        for k in seg:
            seg[k].copy_(seg_s[k])
    loaded = step.dispatch(token, pos, r.block_tables, r.lane).wait()
    np.testing.assert_array_equal(chained, loaded)
    assert torch.equal(out_c, step.out)
    for seg_c, seg in zip(caches_c, r.caches):
        for k in seg:
            assert torch.equal(seg_c[k], seg[k]), k
    # a run from the host arrays breaks the chain until the next dispatch
    step(token, pos, r.block_tables, r.lane)
    assert not step.chainable
    with pytest.raises(RuntimeError, match="not its next inputs"):
        step.chain()


def test_token_fetch_is_waited_once():
    fetch = tsteps.TokenFetch(torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(fetch.wait(), [0, 1, 2])
    with pytest.raises(RuntimeError, match="once"):
        fetch.wait()


def test_shed_is_typed_and_counted():
    """An expired deadline sheds with a typed Rejection instead of a
    guaranteed miss; healthy traffic completes untouched."""
    cfg, params = _model("phi4-mini-3.8b")
    doomed = _reqs(cfg, [8, 12], uid0=0, deadline_ms=0.001)
    healthy = _reqs(cfg, [8, 12], uid0=50, deadline_ms=600_000.0)
    doomed_enc = EncodeTask(uid=90, prompt=np.arange(5, dtype=np.int32),
                            deadline_ms=0.001)
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu",
                          scheduler=DeadlinePolicy())
    for t in doomed + healthy + [doomed_enc]:
        eng.submit(t)
    out = {t.uid: list(getattr(t, "output", [])) for t in eng.run()}
    assert {t.uid for t in eng.shed} == {0, 1, 90}
    for t in eng.shed:
        assert t.rejection.kind == "slo_unattainable"
        assert "deadline_ms" in t.rejection.detail
        assert t.done and t.uid in out
    assert all(out[u] == [] for u in (0, 1))
    assert doomed_enc.embedding is None
    _, want = _run(cfg, params, _reqs(cfg, [8, 12], uid0=50))
    assert {u: out[u] for u in (50, 51)} == want
    st = eng.stats()
    assert st.requests_shed == 3
    assert st.slo_met == 2 and st.slo_requests == 5
    assert st.slo_attainment == pytest.approx(0.4)
    assert "3 shed" in st.summary()


@pytest.mark.parametrize("branches,depth", [(1, 0.0), (2, 0.0), (2, 2.0)])
def test_degraded_spec_is_lossless(branches, depth):
    """degrade_depth 0: any backlog puts the engine at level 2, and every
    request admitted under it speculates no more.  Depth 2 (threshold 4
    queued at 2 slots): the first step's backlog of 6 reaches level 1 only,
    which shrinks a tree engine's trees to chains and degrades no request.
    Tokens never change."""
    cfg, params = _model("phi4-mini-3.8b")
    lens = [5, 11, 9, 6, 13, 7]
    spec = SpecConfig(draft="self", k=3, branches=branches)
    _, base = _run(cfg, params, _reqs(cfg, lens), spec=spec)
    eng, deg = _run(cfg, params, _reqs(cfg, lens), spec=spec,
                    scheduler=DeadlinePolicy(degrade_depth=depth))
    assert deg == base
    st = eng.stats()
    assert st.spec_rounds > 0
    if depth == 0.0:
        assert st.requests_degraded == len(lens)
        assert st.spec_proposed_tokens == 0
        assert all(t.degraded for t in eng.completed)
    else:
        assert st.requests_degraded == 0 and st.spec_proposed_tokens > 0
        assert st.spec_tree_nodes > 0


def test_tree_chain_only_rung_shrinks_every_row():
    cfg, params = _model("phi4-mini-3.8b")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu",
                          spec=SpecConfig(draft="self", k=3, branches=2))
    for r in _reqs(cfg, (6, 9), max_new=8):
        eng.submit(r)
    eng.step()
    r = eng.runner
    wide = r.spec_lookahead()
    assert (r._round_width[r.decoding_slots()] == 2).all()
    r._tree_chain_only = True
    chain = r.spec_lookahead()
    assert (r._round_width == 1).all()
    assert (chain * 2 == wide).all()
    r.slots[0].degraded = True
    assert r.spec_lookahead()[0] == 0


def test_slo_accounting_and_stats_surface():
    cfg, params = _model("gpt-j")
    reqs = _reqs(cfg, [5, 9, 14], deadline_ms=600_000.0,
                 slo_tpot_ms=60_000.0)
    eng, _ = _run(cfg, params, reqs, scheduler=DeadlinePolicy())
    st = eng.stats()
    assert st.slo_requests == 3 and st.slo_attainment == 1.0
    d = st.to_dict()
    for key in ("slo_attainment", "ttft_p99_ms", "ttft_slo_ratio_p50",
                "ttft_slo_ratio_p99", "tpot_p50_ms", "tpot_p99_ms",
                "requests_shed", "requests_degraded", "overlapped_steps",
                "host_overlap_ratio", "queue_wait_p99_ms"):
        assert key in d, key
    assert st.queue_wait_p99_ms >= st.queue_wait_p50_ms >= 0
    assert "SLO 100% met" in st.summary()
    for t in eng.completed:
        assert t.latency_ms > 0 and t.tpot_ms > 0


def test_replay_open_loop_end_to_end():
    """A paced Poisson trace through the overlapped deadline engine:
    loadgen -> replay -> stats."""
    cfg, params = _model("phi4-mini-3.8b")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu",
                          scheduler=DeadlinePolicy(), overlap=True)
    spec = LoadSpec(requests=8, vocab=cfg.vocab,
                    arrival=ArrivalSpec(rate_rps=50.0),
                    prompts=PromptSpec(min_len=4, max_len=16),
                    slo=SLOSpec(ttft_ms=600_000.0), max_new=4)
    replay(eng, make_trace(spec, uid0=1000), time_scale=0)   # warm-up
    eng.reset_stats()
    done, wall = replay(eng, make_trace(spec))
    assert len(done) == 8 and wall > 0
    assert all(t.done and len(t.output) == 4 for t in done)
    st = eng.stats()
    assert st.slo_requests == 8 and st.slo_attainment == 1.0
    assert st.overlapped_steps > 0
    assert not eng.has_work()


@pytest.mark.parametrize("encode_batch", [None, 1])
def test_encode_batch_caps_an_encode_pass(encode_batch):
    cfg, params = _model("gpt-j")
    eng = InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                          policy=FP32, device="cpu",
                          encode_batch=encode_batch)
    for uid in range(4):
        eng.submit(EncodeTask(uid=uid, prompt=np.arange(6, dtype=np.int32)))
    done = eng.run()
    assert len(done) == 4 and all(t.embedding is not None for t in done)
    assert eng.stats().encode_batches == (4 if encode_batch == 1 else 2)
    with pytest.raises(ValueError, match="encode_batch"):
        InferenceEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ,
                        device="cpu", encode_batch=0)

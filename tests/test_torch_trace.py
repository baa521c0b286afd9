"""PyTorch port, the observability layer on the CPU: request-level tracing
and MFU / MBU attribution (`serving/trace.py`, `EngineStats.phase_util`).

Held to the reference (the same documents and numbers):
  * `validate_chrome_trace` and `prometheus_text` give identical results;
  * `derive_phase_metrics` agrees given `peak_flops` and `hbm_bw`.
Held to the port itself, reduced phi4-mini and GPT-J in fp32:
  * traced and untraced runs are token-identical (chunked prefill, a warm
    prefix cache, speculation), and a disabled tracer records nothing;
  * the Chrome trace is schema-clean, its spans ordered and nested under
    the overlapped loop; TTFT rebuilds from the trace alone;
  * `phase_util` agrees with `derive_phase_metrics` on a traced run, and
    defaults to the H100's peaks;
  * the CLI's `--trace-out` / `--metrics-out` artifacts validate and parse.
"""
import copy
import json
import math

import numpy as np
import pytest
import torch

from repro.serving import trace as jtrace
from repro_torch.analysis import roofline as troof
from repro_torch.configs import get_config
from repro_torch.core.precision import FP32
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import (ChunkedPrefillPolicy, DeadlinePolicy,
                                 InferenceEngine, Request, Reservoir,
                                 SamplingParams, SpecConfig, Tracer,
                                 derive_phase_metrics, make_policy,
                                 percentile, prometheus_text,
                                 validate_chrome_trace)
from repro_torch.serving import trace as ttrace
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.trace import PID_ENGINE, PID_REQUEST

# the suite runs beside JAX tests in parallel workers: keep torch from
# claiming every core
torch.set_num_threads(2)

ARCHS = ("phi4-mini-3.8b", "gpt-j")
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = get_config(arch).reduced()
        _MODELS[arch] = (cfg, tlm.init_lm(cfg, dtype=torch.float32,
                                          device="cpu", seed=0))
    return _MODELS[arch]


def _prompts(cfg, lengths, seed=11):
    """lengths entries may be ints (drawn here) or ready-made prompts."""
    rng = np.random.default_rng(seed)
    return [n if isinstance(n, np.ndarray)
            else rng.integers(0, cfg.vocab, n, dtype=np.int32)
            for n in lengths]


def _run(cfg, params, *, tracer=None, overlap=False, scheduler=None,
         prefix_cache=False, spec=None, lengths=(6, 13, 20), max_new=4,
         deadline_ms=0.0):
    engine = InferenceEngine(
        cfg, params, batch_size=2, max_seq=64, policy=FP32, device="cpu",
        overlap=overlap, scheduler=scheduler, prefix_cache=prefix_cache,
        spec=spec, tracer=tracer)
    for i, p in enumerate(_prompts(cfg, lengths)):
        engine.submit(Request(
            uid=i, prompt=p, max_new_tokens=max_new,
            deadline_ms=deadline_ms or None,
            sampling=SamplingParams(temperature=0.8, top_k=20, seed=i)
            if i % 2 else SamplingParams()))
    done = engine.run()
    return engine, {r.uid: list(r.output) for r in done}


_TRACED = {}


def _traced(arch):
    """One overlapped, traced deadline run an arch, shared by the schema,
    ordering, reconstruction and attribution tests."""
    if arch not in _TRACED:
        cfg, params = _model(arch)
        tracer = Tracer()
        engine, out = _run(cfg, params, tracer=tracer, overlap=True,
                           scheduler=DeadlinePolicy(), deadline_ms=60_000.0,
                           lengths=(6, 13, 20, 9), max_new=6)
        _TRACED[arch] = (tracer, engine, out)
    return _TRACED[arch]


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def _documents():
    """Chrome trace documents, clean and broken, from a real port run."""
    tracer, _, _ = _traced("phi4-mini-3.8b")
    good = json.loads(json.dumps(tracer.chrome_trace(), default=str))
    body = [i for i, e in enumerate(good["traceEvents"]) if e["ph"] != "M"]
    docs = {"good": good, "empty": {"traceEvents": []}, "none": {},
            "meta_only": {"traceEvents": good["traceEvents"][:2]}}
    d = copy.deepcopy(good)
    del d["traceEvents"][body[3]]["pid"]
    docs["missing_pid"] = d
    d = copy.deepcopy(good)
    d["traceEvents"][body[2]]["ts"] = "late"
    docs["string_ts"] = d
    d = copy.deepcopy(good)
    x = next(i for i in body if good["traceEvents"][i]["ph"] == "X")
    d["traceEvents"][x]["dur"] = -1.0
    docs["negative_dur"] = d
    d = copy.deepcopy(good)
    d["traceEvents"][body[5]]["ts"] = -1e9
    docs["unsorted"] = d
    d = copy.deepcopy(good)
    for i in body[:30]:
        d["traceEvents"][i].pop("tid")
    docs["truncated"] = d
    return docs


@pytest.mark.parametrize("case", ["good", "empty", "none", "meta_only",
                                  "missing_pid", "string_ts",
                                  "negative_dur", "unsorted", "truncated"])
def test_validate_chrome_trace_matches_reference(case):
    doc = _documents()[case]
    got = validate_chrome_trace(doc)
    assert got == jtrace.validate_chrome_trace(doc)
    assert (got == []) == (case == "good")


def test_prometheus_text_matches_reference():
    _, engine, _ = _traced("gpt-j")
    snaps = [engine.stats().to_dict(), EngineStats().to_dict(),
             {"a": True, "b": 1.5e-9, "c": "x", "d": {"k": 3, "s": "no"},
              "phase_util": {"decode": {"mfu": 0.5, "note": "x"}},
              "buckets": {"8": 2}}]
    for snap in snaps:
        for prefix in ("serving", "port"):
            assert prometheus_text(snap, prefix) == jtrace.prometheus_text(
                snap, prefix)


@pytest.mark.parametrize("arch", ARCHS)
def test_derive_phase_metrics_matches_reference(arch):
    tracer, engine, _ = _traced(arch)
    st = engine.stats()
    events = json.loads(json.dumps(tracer.events, default=str))
    kw = dict(flops_per_token=st.model_flops_per_token,
              weight_bytes=st.weight_bytes_per_device,
              kv_bytes_per_token=st.kv_bytes_per_token,
              peak_flops=197e12, hbm_bw=819e9)
    got = derive_phase_metrics(events, **kw)
    want = jtrace.derive_phase_metrics(events, **kw)
    assert got.keys() == want.keys() >= {"prefill", "decode"}
    for phase in got:
        assert got[phase].keys() == want[phase].keys()
        for k in got[phase]:
            assert got[phase][k] == pytest.approx(want[phase][k], rel=1e-12)


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------

def test_disabled_tracer_is_noop():
    cfg, params = _model("phi4-mini-3.8b")
    tracer = Tracer(enabled=False)
    assert not tracer
    _, traced = _run(cfg, params, tracer=tracer)
    _, plain = _run(cfg, params, tracer=None)
    assert len(tracer.events) == 0
    assert traced == plain


def test_ring_buffer_evicts_oldest():
    tracer = Tracer(capacity=4)
    for i in range(10):
        tracer.instant(f"e{i}", float(i), tid=0)
    assert len(tracer) == 4 and tracer.dropped == 6
    assert [e["name"] for e in tracer.events] == ["e6", "e7", "e8", "e9"]
    assert tracer.chrome_trace()["otherData"]["dropped_events"] == 6
    tracer.clear()
    assert len(tracer) == 0 and tracer.dropped == 0
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_chrome_trace_schema(arch, tmp_path):
    tracer, _, _ = _traced(arch)
    assert len(tracer.events) > 0
    assert validate_chrome_trace(tracer.chrome_trace()) == []
    path = tmp_path / "trace.json"
    assert tracer.write(str(path)) == len(tracer.events)
    loaded = json.loads(path.read_text())
    assert validate_chrome_trace(loaded) == []
    assert all(ev["dur"] >= 0 for ev in loaded["traceEvents"]
               if ev["ph"] == "X")
    assert ttrace.main([str(path)]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_span_ordering_and_nesting(arch):
    """Exported timestamps are monotonic under the overlapped loop, and each
    request's first_token sits inside its request span on its own row."""
    tracer, _, out = _traced(arch)
    doc = tracer.chrome_trace()
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)
    spans = {e["tid"]: e for e in doc["traceEvents"]
             if e.get("cat") == "request" and e["name"] == "request"}
    firsts = {e["tid"]: e for e in doc["traceEvents"]
              if e["name"] == "first_token"}
    queues = {e["tid"]: e for e in doc["traceEvents"]
              if e["name"] == "queue"}
    assert set(spans) == set(out) == set(firsts) == set(queues)
    for uid, span in spans.items():
        assert span["pid"] == PID_REQUEST
        assert span["ts"] <= firsts[uid]["ts"] <= span["ts"] + span["dur"]
        assert span["ts"] <= queues[uid]["ts"] + queues[uid]["dur"] \
            <= firsts[uid]["ts"]
        assert queues[uid]["args"]["policy"] == "deadline"
        assert "edf_slack_ms" in queues[uid]["args"]
    steps = [e for e in doc["traceEvents"] if e.get("cat") == "step"]
    assert steps and all(e["pid"] == PID_ENGINE for e in steps)
    assert {"prefill", "decode_step", "decode_dispatch",
            "engine_step"} <= {e["name"] for e in steps}
    # the overlapped loop: decode spans carry the dispatch-to-fetch lag
    decodes = [e for e in steps if e["name"] == "decode_step"]
    assert all("overlap_lag_ms" in e["args"] for e in decodes)


@pytest.mark.parametrize("arch", ARCHS)
def test_ttft_reconstruction(arch):
    """TTFT from the trace alone (first_token instant minus the request
    span's start) equals the value the span carries."""
    tracer, engine, _ = _traced(arch)
    doc = tracer.chrome_trace()
    spans = {e["tid"]: e for e in doc["traceEvents"]
             if e.get("cat") == "request" and e["name"] == "request"}
    firsts = {e["tid"]: e for e in doc["traceEvents"]
              if e["name"] == "first_token"}
    for uid, span in spans.items():
        ttft_ms = (firsts[uid]["ts"] - span["ts"]) / 1e3
        assert ttft_ms == pytest.approx(span["args"]["ttft_ms"], abs=0.1)
    by_uid = {t.uid: t for t in engine.completed}
    for uid, span in spans.items():
        assert span["args"]["ttft_ms"] == by_uid[uid].ttft_ms


def _mode_kwargs(cfg, mode):
    if mode == "chunked":
        return dict(scheduler=ChunkedPrefillPolicy(8), lengths=(30, 6, 25))
    if mode == "warm_prefix":
        rng = np.random.default_rng(4)
        shared = rng.integers(0, cfg.vocab, 24, dtype=np.int32)
        lengths = tuple(np.concatenate([shared, t]) for t in
                        _prompts(cfg, (4, 6, 5), seed=5))
        return dict(prefix_cache=True, lengths=lengths,
                    scheduler=make_policy("fcfs", cache_aware=True))
    if mode == "spec":
        return dict(spec=SpecConfig(draft="self", k=2))
    return dict(spec=SpecConfig(draft="self", k=2, branches=2))


@pytest.mark.parametrize("mode", ["chunked", "warm_prefix", "spec", "tree"])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_identity_traced_vs_untraced(arch, mode):
    """Tracing is a pure observer: the same tokens with the tracer attached,
    on the hook-heavy paths."""
    cfg, params = _model(arch)
    kw = _mode_kwargs(cfg, mode)
    tracer = Tracer()
    _, traced = _run(cfg, params, tracer=tracer, **kw)
    _, plain = _run(cfg, params, tracer=None, **kw)
    assert traced == plain
    assert len(tracer.events) > 0
    assert validate_chrome_trace(tracer.chrome_trace()) == []


def test_warm_prefix_and_preempt_instants():
    """A second pass over a shared prefix emits warm_hit (and the shared
    tail's copy-on-write); an undersized pool emits preempt."""
    cfg, params = _model("gpt-j")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab, 24, dtype=np.int32)
    tracer = Tracer()
    engine = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                             policy=FP32, device="cpu", prefix_cache=True,
                             scheduler=make_policy("fcfs", cache_aware=True),
                             tracer=tracer)
    uid = 0
    for _ in range(2):
        for t in _prompts(cfg, (4, 6), seed=5):
            engine.submit(Request(uid=uid, max_new_tokens=3,
                                  prompt=np.concatenate([shared, t])))
            uid += 1
        engine.run()
    hit = next(e for e in tracer.events if e["name"] == "warm_hit")
    assert hit["args"]["cached_prefix"] > 0 and hit["args"]["cow"]
    chunks = [e for e in tracer.events if e["name"] == "prefill_chunk"]
    assert chunks and all(e["args"]["phase"] == "prefill" for e in chunks)
    tracer = Tracer()
    small = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                            policy=FP32, device="cpu", kv_pool_blocks=4,
                            block_size=16, tracer=tracer)
    for i, p in enumerate(_prompts(cfg, (20, 20))):
        small.submit(Request(uid=10 + i, prompt=p, max_new_tokens=20))
    small.run()
    assert small.stats().preemptions > 0
    pre = [e for e in tracer.events if e["name"] == "preempt"]
    assert len(pre) == small.stats().preemptions
    assert all(e["args"]["recompute_tokens"] > 0 for e in pre)


@pytest.mark.parametrize("branches", [1, 2])
def test_spec_trace_annotations(branches):
    cfg, params = _model("phi4-mini-3.8b")
    tracer = Tracer()
    engine, _ = _run(cfg, params, tracer=tracer,
                     spec=SpecConfig(draft="self", k=2, branches=branches))
    verifies = [e for e in tracer.events if e["name"] == "spec_verify"]
    drafts = [e for e in tracer.events if e["name"] == "spec_draft"]
    assert len(verifies) == len(drafts) == engine.stats().spec_rounds
    for v in verifies:
        a = v["args"]
        assert a["phase"] == "verify"
        assert a["proposed"] >= a["accepted"] >= 0
        assert 0.0 <= a["accept_rate"] <= 1.0
        assert ("tree_nodes" in a) == (branches > 1)
    assert sum(v["args"]["tokens"] for v in verifies) == \
        engine.stats().verify_positions
    pu = engine.stats().phase_util()
    assert "verify" in pu and "decode" not in pu
    assert pu["verify"]["mfu"] > 0


def test_shed_and_degrade_spans():
    cfg, params = _model("phi4-mini-3.8b")
    tracer = Tracer()
    engine = InferenceEngine(cfg, params, batch_size=2, max_seq=64,
                             policy=FP32, device="cpu", tracer=tracer,
                             spec=SpecConfig(draft="self", k=2),
                             scheduler=DeadlinePolicy(degrade_depth=0.0))
    prompts = _prompts(cfg, (5, 7, 9, 6))
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=3,
                              deadline_ms=0.001 if i == 0 else 600_000.0))
    engine.run()
    shed = [e for e in tracer.events if e["name"] == "shed"]
    assert [e["tid"] for e in shed] == [0]
    assert shed[0]["args"]["reason"] == "slo_unattainable"
    degrade = [e for e in tracer.events if e["name"] == "degrade"]
    assert len(degrade) == engine.stats().requests_degraded > 0
    steps = [e for e in tracer.events if e["name"] == "engine_step"]
    assert steps and max(e["args"]["degrade"] for e in steps) >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_phase_util_and_trace_derivation_agree(arch):
    """stats.phase_util() (the counters) and derive_phase_metrics (the
    trace) give the same per-phase MFU / MBU, against the H100's peaks."""
    tracer, engine, _ = _traced(arch)
    st = engine.stats()
    pu = st.phase_util()
    assert set(pu) == {"prefill", "decode"}
    for row in pu.values():
        assert row["mfu"] > 0 and row["mbu"] > 0 and row["time_s"] > 0
    derived = derive_phase_metrics(
        tracer.events, flops_per_token=st.model_flops_per_token,
        weight_bytes=st.weight_bytes_per_device,
        kv_bytes_per_token=st.kv_bytes_per_token)
    for phase in ("prefill", "decode"):
        for key in ("time_s", "tokens", "flops", "hbm_bytes", "mfu", "mbu"):
            assert derived[phase][key] == pytest.approx(
                pu[phase][key], rel=1e-6), (phase, key)
    row = pu["decode"]
    assert row["mfu"] == pytest.approx(
        row["flops"] / (row["time_s"] * troof.PEAK_BF16))
    assert row["mbu"] == pytest.approx(
        row["hbm_bytes"] / (row["time_s"] * troof.HBM_BW))
    d = st.to_dict()
    assert d["phase_util"] == pu
    assert d["model_flops_per_token"] == troof.decoder_flops_per_token(
        engine.runner.cfg)
    assert d["kv_bytes_per_token"] == st.kv_pool_bytes / (
        engine.runner.layout.num_blocks * engine.runner.layout.block_size)
    assert EngineStats().phase_util() == {}


def test_reservoir_keeps_late_outliers():
    r = Reservoir(capacity=64, seed=0)
    for _ in range(64):
        r.add(1.0)
    for _ in range(10_000):
        r.add(1000.0)
    assert len(r) == 64 and r.seen == 10_064
    assert percentile(r, 99) == 1000.0


def test_prometheus_text_snapshot():
    _, engine, _ = _traced("phi4-mini-3.8b")
    text = prometheus_text(engine.stats().to_dict())
    assert "serving_ar_tok_s" in text
    assert 'serving_phase_mfu{phase="decode"}' in text
    assert "serving_overlapped_steps" in text
    for line in text.splitlines():
        if line:
            name, val = line.rsplit(" ", 1)
            assert math.isfinite(float(val)), line


def test_cli_trace_and_metrics_artifacts(tmp_path, capsys):
    """`--overlap --policy deadline --deadline-ms --trace-out --metrics-out`:
    the trace validates through the module's main, the metrics parse, and
    the tokens equal the synchronous FCFS CLI run's."""
    base = ["--arch", "gpt-j", "--reduced", "--device", "cpu", "--requests",
            "5", "--batch", "2", "--prompt-len", "40", "--min-prompt-len",
            "6", "--max-new", "5", "--max-seq", "64", "--seed", "4",
            "--temperature", "0.8", "--top-k", "20"]
    trace_path, prom = tmp_path / "t.json", tmp_path / "m.prom"
    argv = base + ["--overlap", "--policy", "deadline", "--deadline-ms",
                   "600000", "--trace-out", str(trace_path),
                   "--trace-buffer", "4096", "--metrics-out", str(prom)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "overlap" in out
    assert "SLO 100% met (5/5" in out and "OVERLAP" in out
    assert "util: prefill MFU" in out and "trace:" in out
    assert ttrace.main([str(trace_path)]) == 0
    doc = json.loads(trace_path.read_text())
    assert doc["otherData"]["capacity"] == 4096
    samples = {}
    for line in prom.read_text().splitlines():
        name, val = line.rsplit(" ", 1)
        samples[name] = float(val)
    assert samples["serving_requests_completed"] == 5
    assert samples["serving_slo_attainment"] == 1.0
    args = serve.parser().parse_args(argv)
    eng, done, _ = serve.run(args)
    assert eng.overlap and eng.scheduler.name == "deadline"
    assert all(t.deadline_ms == 600000.0 for t in done)
    _, want, _ = serve.run(serve.parser().parse_args(base))
    assert {t.uid: t.output for t in done} == {t.uid: t.output
                                              for t in want}

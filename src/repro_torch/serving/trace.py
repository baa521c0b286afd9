"""Request-level tracing and MFU / MBU attribution for the serving engine
(port of the reference's serving/trace.py).

`Tracer` is a bounded structured tracer:

  request rows (pid 2, tid = uid)   lifecycle spans and instants: submit
      -> queue -> (warm_hit | degrade | preempt | shed) -> first_token ->
      retire ("request" span).  Policy decisions annotate the spans: EDF
      slack at admission, shed reason, degrade rung, copies on write,
      cached-prefix length, tree accept depth.
  engine row (pid 1, tid 0)         step spans: prefill / prefill_chunk /
      decode (dispatch and commit apart, the overlap lag, the batch) /
      spec_draft / spec_verify / encode, and one "engine_step" span an
      engine iteration.

Events land in a ring buffer (drop-oldest) and export as Chrome
trace-event JSON (`chrome_trace` / `write`, viewable at
https://ui.perfetto.dev), or an `EngineStats.to_dict()` exports as
Prometheus text (`prometheus_text`).

Tracing is opt-in: every hook site in engine.py / runner.py guards on one
`if tracer:` branch (`__bool__` is the enabled flag), so a disabled or
absent tracer costs one falsy check a hook and records nothing.  Hooks are
pure observers: tokens are identical either way.  Span times are host
wall-clock (`time.perf_counter`, the clock of every EngineStats latency);
a step span's `busy_ms` is the host wall around the pass and its fetch,
as in the reference, not CUDA-event time.

`derive_phase_metrics` joins the step spans with the FLOP / byte model of
`analysis/roofline.py` (the H100's peaks by default) into MFU / MBU a
serving phase; `EngineStats.phase_util()` computes the same from counters
alone, and the two agree on a traced run.

Validating an artifact:

    PYTHONPATH=src python -m repro_torch.serving.trace TRACE.json
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

# Chrome trace-event process rows: one for engine steps, one per-request.
PID_ENGINE = 1
PID_REQUEST = 2


class Tracer:
    """Bounded ring-buffer tracer for one engine.

    `capacity` bounds the buffer (drop-oldest beyond it; `dropped` counts
    the evictions, so a truncated artifact is never mistaken for a
    complete one).  Timestamps are `time.perf_counter()` values in
    microseconds from the tracer's construction: the clock of every
    EngineStats latency, so TTFT / TPOT rebuilt from the trace match the
    stats to float rounding."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.epoch = time.perf_counter()
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0

    def __bool__(self) -> bool:
        # every hook site is `if tracer: ...`: a disabled tracer (or None)
        # costs one falsy check and nothing else
        return self.enabled

    @property
    def events(self) -> List[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self):
        self._ring.clear()
        self.dropped = 0

    # -- recording ------------------------------------------------------
    def _ts(self, t: float) -> float:
        return (t - self.epoch) * 1e6            # µs, Chrome's unit

    def _push(self, ev: dict):
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)

    def span(self, name: str, t0: float, t1: float, *, pid: int, tid: int,
             cat: str, **args):
        """One complete ('X') event: [t0, t1] perf_counter seconds."""
        self._push({"name": name, "ph": "X", "cat": cat,
                    "ts": self._ts(t0), "dur": max(0.0, (t1 - t0) * 1e6),
                    "pid": pid, "tid": tid, "args": args})

    def step_span(self, name: str, t0: float, t1: float, **args):
        """Engine-row span (pid 1, tid 0): prefill / decode / verify /
        encode passes and the per-iteration engine_step wrapper."""
        self.span(name, t0, t1, pid=PID_ENGINE, tid=0, cat="step", **args)

    def request_span(self, uid: int, name: str, t0: float, t1: float,
                     **args):
        """Request-row span (pid 2, tid = uid): queue / shed / request."""
        self.span(name, t0, t1, pid=PID_REQUEST, tid=int(uid),
                  cat="request", **args)

    def instant(self, name: str, t: float, *, tid: int,
                pid: int = PID_REQUEST, **args):
        """One instant ('i') event — submit, first_token, warm_hit,
        cow_copy, degrade, preempt markers."""
        self._push({"name": name, "ph": "i", "cat": "mark", "s": "t",
                    "ts": self._ts(t), "pid": pid, "tid": int(tid),
                    "args": args})

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).  Events are
        sorted by timestamp; metadata events name the process/thread rows."""
        evs = sorted(self._ring, key=lambda e: e["ts"])
        meta = [
            {"name": "process_name", "ph": "M", "pid": PID_ENGINE, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "thread_name", "ph": "M", "pid": PID_ENGINE, "tid": 0,
             "args": {"name": "steps"}},
            {"name": "process_name", "ph": "M", "pid": PID_REQUEST,
             "tid": 0, "args": {"name": "requests"}},
        ]
        for tid in sorted({e["tid"] for e in evs
                           if e["pid"] == PID_REQUEST}):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_REQUEST, "tid": tid,
                         "args": {"name": f"req {tid}"}})
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "capacity": self.capacity}}

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f, default=_jsonable)
        return len(self._ring)


def _jsonable(x):
    """json.dump fallback for numpy scalars riding in span args."""
    if hasattr(x, "item"):
        return x.item()
    return str(x)


# -- validation ----------------------------------------------------------
_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema-check a Chrome trace-event document: non-empty, required
    fields present and numeric where they must be, 'X' events with a
    non-negative dur, non-metadata timestamps monotonic (the export sorts:
    an unsorted artifact means a broken writer).  Returns the problems
    (empty = clean)."""
    problems = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    body = [e for e in evs if e.get("ph") != "M"]
    if not body:
        problems.append("no non-metadata events")
    last_ts = None
    for i, e in enumerate(body):
        for k in _REQUIRED:
            if k not in e:
                problems.append(f"event {i} ({e.get('name')!r}): "
                                f"missing field {k!r}")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({e.get('name')!r}): "
                            f"non-numeric ts {ts!r}")
            continue
        if e.get("ph") == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({e.get('name')!r}): "
                                f"'X' event needs dur >= 0, got {dur!r}")
        if last_ts is not None and ts < last_ts:
            problems.append(f"event {i} ({e.get('name')!r}): timestamp "
                            f"{ts} < predecessor {last_ts} "
                            f"(not monotonic)")
        last_ts = ts
        if len(problems) >= 20:
            problems.append("... (truncated)")
            break
    return problems


# -- interval metrics: step spans joined with the FLOP / byte model -------
def derive_phase_metrics(events: Iterable[dict], *, flops_per_token: float,
                         weight_bytes: float, kv_bytes_per_token: float,
                         peak_flops: Optional[float] = None,
                         hbm_bw: Optional[float] = None) -> Dict[str, dict]:
    """Per-phase achieved MFU / MBU from recorded step spans.

    Every compute span (prefill / prefill_chunk / decode_step /
    spec_verify / encode) carries `phase`, `tokens` (positions the pass
    ran, padding included), `kv_positions` (live KV positions it read or
    wrote), `passes` and `busy_ms` (host wall around the pass, floored
    against pipelined neighbours so overlapped steps never count twice).

      MFU = flops_per_token * tokens / (busy_s * peak)
      MBU = (weight_bytes * passes + kv_bytes_per_token * kv_positions)
            / (busy_s * bw)

    `flops_per_token` is the analytic forward cost
    (`analysis/roofline.decoder_flops_per_token`); peak and bandwidth
    default to the H100's (`analysis/roofline.PEAK_BF16`, `HBM_BW`).  The
    "draft" phase reports time only (its FLOPs are a smaller model's)."""
    from repro_torch.analysis import roofline
    peak = peak_flops if peak_flops is not None else roofline.PEAK_BF16
    bw = hbm_bw if hbm_bw is not None else roofline.HBM_BW
    acc: Dict[str, dict] = {}
    for e in events:
        args = e.get("args") or {}
        phase = args.get("phase")
        if e.get("cat") != "step" or phase is None:
            continue
        a = acc.setdefault(phase, {"time_s": 0.0, "tokens": 0,
                                   "kv_positions": 0, "passes": 0})
        busy = args.get("busy_ms")
        a["time_s"] += (busy / 1e3 if busy is not None
                        else e.get("dur", 0.0) / 1e6)
        a["tokens"] += int(args.get("tokens", 0))
        a["kv_positions"] += int(args.get("kv_positions", 0))
        a["passes"] += int(args.get("passes", 0))
    out: Dict[str, dict] = {}
    for phase, a in acc.items():
        t = a["time_s"]
        flops = flops_per_token * a["tokens"]
        mem = weight_bytes * a["passes"] + kv_bytes_per_token * a[
            "kv_positions"]
        out[phase] = {
            **a,
            "flops": flops,
            "hbm_bytes": mem,
            "mfu": flops / (t * peak) if t > 0 else 0.0,
            "mbu": mem / (t * bw) if t > 0 else 0.0,
        }
    return out


# -- flat Prometheus-style text snapshot --------------------------------
def prometheus_text(snapshot: dict, prefix: str = "serving") -> str:
    """Flatten an `EngineStats.to_dict()` into Prometheus text exposition
    format: scalars become `<prefix>_<key> <value>`, one-level dicts
    labelled series (`bucket_hits` -> {bucket="8"}, `phase_util` -> a
    {phase="decode"} series a metric), and string fields one
    `<prefix>_info{...} 1` metric."""
    lines: List[str] = []
    info: Dict[str, str] = {}
    for key, val in snapshot.items():
        if isinstance(val, bool):
            lines.append(f"{prefix}_{key} {int(val)}")
        elif isinstance(val, (int, float)):
            lines.append(f"{prefix}_{key} {val:g}")
        elif isinstance(val, str):
            info[key] = val
        elif isinstance(val, dict):
            if key == "phase_util":
                for phase, m in val.items():
                    for mk, mv in m.items():
                        if isinstance(mv, (int, float)):
                            lines.append(
                                f'{prefix}_phase_{mk}{{phase="{phase}"}} '
                                f"{mv:g}")
            else:
                label = key.rstrip("s") or key
                for k, v in val.items():
                    if isinstance(v, (int, float)):
                        lines.append(
                            f'{prefix}_{key}{{{label}="{k}"}} {v:g}')
    if info:
        labels = ",".join(f'{k}="{v}"' for k, v in sorted(info.items()))
        lines.append(f"{prefix}_info{{{labels}}} 1")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    """Validate a trace artifact: non-empty, schema-clean, monotonic
    timestamps.  Exit 1 (with the problems on stderr) otherwise."""
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        description="validate a serving trace artifact (Chrome trace JSON)")
    ap.add_argument("trace", help="path to a Tracer.write() artifact")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    problems = validate_chrome_trace(doc)
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") != "M"]
    reqs = {e["tid"] for e in evs if e.get("pid") == PID_REQUEST}
    span = (max((e["ts"] + e.get("dur", 0) for e in evs), default=0)
            - min((e["ts"] for e in evs), default=0))
    print(f"{args.trace}: {len(evs)} events, {len(reqs)} request rows, "
          f"{span / 1e3:.1f}ms span, "
          f"{doc.get('otherData', {}).get('dropped_events', 0)} dropped")
    if problems:
        for p in problems:
            print(f"  INVALID: {p}", file=sys.stderr)
        return 1
    print("  schema clean, timestamps monotonic")
    return 0


__all__ = ["Tracer", "PID_ENGINE", "PID_REQUEST", "validate_chrome_trace",
           "derive_phase_metrics", "prometheus_text"]

if __name__ == "__main__":
    import sys
    sys.exit(main())

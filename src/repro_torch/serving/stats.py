"""Serving telemetry (port of the reference's serving/stats.py): the
paper's NAR / AR split, the encode (EncodeTask) side, TTFT, queue-wait,
decode-step, decode-stall and encode latency percentiles, length bucket
hits, the chunked-prefill counters, preemptions and KV pool use (blocks and
live tokens a decode step: `blocks_per_token`), the prefix cache's lookups,
hits, reused tokens and copy-on-write copies, the storage dtypes and
resident bytes of the weights and KV caches (the `QUANT` part of the
summary under int8), the speculative-decoding counters (rounds, proposals,
acceptance, verify positions, draft time, token-tree nodes, accepted path
depths and branch hits: the `SPEC` part), the goodput counters (SLO
attainment, shed and degraded requests, TTFT / deadline ratios: the `SLO`
part), the overlapped loop's (`overlapped_steps`, `host_overlap_ratio`:
the `OVERLAP` part) and the per-phase MFU / MBU attribution
(`phase_util`, against the H100's peaks in `analysis/roofline.py`).  The
port's prefill and encode steps run eagerly (`launch/steps.py`);
`prefill_compiles` / `encode_compiles` count the distinct step callables
built, as the reference counts its compiled steps.  The decode step is
built once per runner, and on a card captured in one CUDA graph."""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    s = sorted(values)
    rank = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[rank]


def percentiles(values: List[float], qs=(50, 95, 99)) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} in one sorted pass."""
    if not values:
        return {f"p{q:g}": 0.0 for q in qs}
    s = sorted(values)
    hi = len(s) - 1
    return {f"p{q:g}": s[max(0, min(hi, int(round(q / 100.0 * hi))))]
            for q in qs}


MAX_SAMPLES = 4096


class Reservoir(List[float]):
    """Uniform reservoir sample (Algorithm R) that is a list; seeded, so two
    engines fed the same samples hold identical reservoirs."""

    def __init__(self, capacity: int = MAX_SAMPLES, seed: int = 0):
        super().__init__()
        self.capacity = capacity
        self.seen = 0
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.seen += 1
        if len(self) < self.capacity:
            self.append(v)
            return
        j = self._rng.randrange(self.seen)
        if j < self.capacity:
            self[j] = v


@dataclass
class EngineStats:
    batch_size: int = 0
    requests_submitted: int = 0
    requests_completed: int = 0
    # -- NAR (prompt encoding / prefill) ------------------------------------
    nar_tokens: int = 0            # true prompt tokens encoded
    padded_nar_tokens: int = 0     # incl. length-bucket padding computed
    nar_time_s: float = 0.0
    prefill_batches: int = 0
    prefill_compiles: int = 0      # distinct (bucket, group-size) steps
    # -- AR (decode) --------------------------------------------------------
    ar_tokens: int = 0
    ar_time_s: float = 0.0
    decode_steps: int = 0
    occupied_slot_steps: int = 0
    decode_step_ms: List[float] = field(default_factory=Reservoir)
    # -- encoder-only (EncodeTask) ------------------------------------------
    encode_tokens: int = 0         # true tokens through pooled passes
    padded_encode_tokens: int = 0  # incl. length-bucket padding computed
    encode_time_s: float = 0.0
    encode_batches: int = 0        # batched pooled passes run
    encode_compiles: int = 0       # distinct (bucket, group, pooling) steps
    encode_latency_ms: List[float] = field(default_factory=Reservoir)
    # -- chunked prefill ----------------------------------------------------
    prefill_chunks: int = 0        # chunk passes run
    chunked_prefill_tokens: int = 0  # true prompt tokens through chunks
    # -- speculative decoding -----------------------------------------------
    spec_rounds: int = 0           # propose->verify->commit rounds run
    spec_slot_steps: int = 0       # decoding slots summed over rounds
    spec_proposed_tokens: int = 0  # draft tokens proposed
    spec_accepted_tokens: int = 0  # of those, accepted by the target
    spec_emitted_tokens: int = 0   # tokens committed by verify passes
    verify_positions: int = 0      # target positions run by verify passes
    #                                (chain: the chunk lengths; tree: the
    #                                nodes, root included, a slot-round)
    spec_draft_time_s: float = 0.0  # wall time of draft steps and prefills
    draft_time_ms: List[float] = field(default_factory=Reservoir)  # a
    #                                round's draft steps
    # token-tree speculation (zero under chain rounds)
    spec_tree_nodes: int = 0       # tree nodes verified (root included)
    spec_branch_hits: int = 0      # slot-rounds whose accepted path left
    #                                the draft's sampled chain
    spec_path_depth: List[float] = field(default_factory=Reservoir)  # the
    #                                accepted root path's depth a slot-round
    # -- serving-level ------------------------------------------------------
    ttft_ms: List[float] = field(default_factory=Reservoir)
    queue_wait_ms: List[float] = field(default_factory=Reservoir)
    # gap between consecutive decode steps while slots were decoding: the
    # time running requests sat stalled behind admission work
    decode_stall_ms: List[float] = field(default_factory=Reservoir)
    tpot_ms_samples: List[float] = field(default_factory=Reservoir)
    bucket_hits: Dict[int, int] = field(default_factory=dict)
    # -- paged KV pool ------------------------------------------------------
    kv_pool_blocks: int = 0
    kv_block_size: int = 0
    peak_blocks_used: int = 0
    preemptions: int = 0
    recompute_tokens: int = 0
    recompute_time_s: float = 0.0
    block_slot_steps: int = 0      # sum over decode steps of blocks in use
    token_slot_steps: int = 0      # sum over decode steps of live tokens
    # -- prefix cache (serving/prefix_cache.py) -----------------------------
    prefix_lookups: int = 0        # admission-time cache lookups
    prefix_hits: int = 0           # of those, lookups matching >= 1 token
    cached_prefix_tokens: int = 0  # prompt tokens served from cached blocks
    cached_blocks: int = 0         # blocks the index holds now (gauge)
    evicted_blocks: int = 0        # index blocks LRU-reclaimed by the pool
    cow_copies: int = 0            # shared blocks duplicated before a write
    # -- storage --------------------------------------------------------------
    weight_dtype: str = "bfloat16"  # GEMM weight storage ("int8" = quantized)
    kv_dtype: str = "bfloat16"      # paged-pool storage ("int8" = quantized)
    weight_bytes_per_device: int = 0  # resident parameter bytes
    kv_pool_bytes: int = 0            # resident decode-cache bytes
    # -- goodput / SLO (serving/loadgen.py, DeadlinePolicy) ------------------
    slo_requests: int = 0          # finished requests that carried an SLO
    slo_met: int = 0               # of those, TTFT and TPOT budgets both met
    requests_shed: int = 0         # dropped unserved (SLO provably missed)
    requests_degraded: int = 0     # admitted under pressure: speculation
    #                                off for them (tokens unchanged)
    # TTFT / deadline a SLO'd request (< 1.0 = met)
    ttft_slo_ratio: List[float] = field(default_factory=Reservoir)
    # -- utilization attribution (serving/trace.py, analysis/roofline.py) ----
    # per-token constants the engine stamps at construction, so that
    # phase_util() turns phase (time, token) sums into MFU / MBU
    model_flops_per_token: float = 0.0  # analytic forward FLOPs a position
    kv_bytes_per_token: float = 0.0     # KV bytes read a attended position
    # -- the overlapped host loop (engine overlap=True) ----------------------
    overlapped_steps: int = 0      # decode steps whose token fetch was
    #                                deferred past host scheduling work
    overlap_host_s: float = 0.0    # host wall between dispatching a step
    #                                and fetching its tokens: host work
    #                                hidden under device time

    def add_ttft_ms(self, v: float) -> None:
        self.ttft_ms.add(v)

    def add_decode_step_ms(self, v: float) -> None:
        self.decode_step_ms.add(v)

    def add_queue_wait_ms(self, v: float) -> None:
        self.queue_wait_ms.add(v)

    def add_decode_stall_ms(self, v: float) -> None:
        self.decode_stall_ms.add(v)

    def add_tpot_ms(self, v: float) -> None:
        self.tpot_ms_samples.add(v)

    def add_encode_latency_ms(self, v: float) -> None:
        self.encode_latency_ms.add(v)

    def add_draft_time_ms(self, v: float) -> None:
        self.draft_time_ms.add(v)

    def add_spec_path_depth(self, v: float) -> None:
        self.spec_path_depth.add(v)

    def record_slo(self, task) -> None:
        """Score a finished task against its SLOs at retirement: TTFT
        against `deadline_ms` (an EncodeTask's latency: its only response
        is its first) and mean TPOT against `slo_tpot_ms`.  No-op for a
        task without SLO."""
        dl = getattr(task, "deadline_ms", None)
        tpot_budget = getattr(task, "slo_tpot_ms", None)
        if dl is None and tpot_budget is None:
            return
        self.slo_requests += 1
        met = True
        if dl is not None:
            ttft = getattr(task, "ttft_ms", 0.0) or task.latency_ms
            self.ttft_slo_ratio.add(ttft / dl)
            met = met and ttft <= dl
        if tpot_budget is not None and len(getattr(task, "output", ())) > 1:
            met = met and task.tpot_ms <= tpot_budget
        if met:
            self.slo_met += 1

    def record_shed(self, task) -> None:
        """Count a shed request, as a missed SLO (an SLO the engine
        refused to attempt is an SLO missed)."""
        self.requests_shed += 1
        if (getattr(task, "deadline_ms", None) is not None
                or getattr(task, "slo_tpot_ms", None) is not None):
            self.slo_requests += 1

    @property
    def nar_tok_s(self) -> float:
        return self.nar_tokens / self.nar_time_s if self.nar_time_s else 0.0

    @property
    def ar_tok_s(self) -> float:
        return self.ar_tokens / self.ar_time_s if self.ar_time_s else 0.0

    @property
    def encode_tok_s(self) -> float:
        """Encoder-only throughput: true tokens through pooled passes / s."""
        return (self.encode_tokens / self.encode_time_s
                if self.encode_time_s else 0.0)

    @property
    def encode_completed(self) -> int:
        """EncodeTasks finished (every one adds a latency sample)."""
        return self.encode_latency_ms.seen

    @property
    def slot_occupancy(self) -> float:
        total = self.decode_steps * self.batch_size
        return self.occupied_slot_steps / total if total else 0.0

    @property
    def padding_overhead(self) -> float:
        if not self.padded_nar_tokens:
            return 0.0
        return 1.0 - self.nar_tokens / self.padded_nar_tokens

    @property
    def ttft_p50_ms(self) -> float:
        return percentile(self.ttft_ms, 50)

    @property
    def ttft_p95_ms(self) -> float:
        return percentile(self.ttft_ms, 95)

    @property
    def ttft_p99_ms(self) -> float:
        return percentile(self.ttft_ms, 99)

    @property
    def slo_attainment(self) -> float:
        """Fraction of SLO-carrying requests that met every budget (shed
        requests count as missed)."""
        if not self.slo_requests:
            return 0.0
        return self.slo_met / self.slo_requests

    @property
    def host_overlap_ratio(self) -> float:
        """Fraction of AR decode wall during which the host did scheduling
        or admission work beside an in-flight device step (0.0 under the
        synchronous loop)."""
        if not self.ar_time_s:
            return 0.0
        return min(1.0, self.overlap_host_s / self.ar_time_s)

    @property
    def queue_wait_p50_ms(self) -> float:
        return percentile(self.queue_wait_ms, 50)

    @property
    def queue_wait_p95_ms(self) -> float:
        return percentile(self.queue_wait_ms, 95)

    @property
    def queue_wait_p99_ms(self) -> float:
        return percentile(self.queue_wait_ms, 99)

    @property
    def decode_step_p50_ms(self) -> float:
        return percentile(self.decode_step_ms, 50)

    @property
    def decode_step_p95_ms(self) -> float:
        return percentile(self.decode_step_ms, 95)

    @property
    def decode_step_p99_ms(self) -> float:
        return percentile(self.decode_step_ms, 99)

    @property
    def decode_stall_p50_ms(self) -> float:
        return percentile(self.decode_stall_ms, 50)

    @property
    def decode_stall_p95_ms(self) -> float:
        return percentile(self.decode_stall_ms, 95)

    @property
    def decode_stall_p99_ms(self) -> float:
        return percentile(self.decode_stall_ms, 99)

    @property
    def encode_latency_p50_ms(self) -> float:
        return percentile(self.encode_latency_ms, 50)

    @property
    def encode_latency_p95_ms(self) -> float:
        return percentile(self.encode_latency_ms, 95)

    @property
    def encode_latency_p99_ms(self) -> float:
        return percentile(self.encode_latency_ms, 99)

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of draft-proposed tokens the target accepted."""
        if not self.spec_proposed_tokens:
            return 0.0
        return self.spec_accepted_tokens / self.spec_proposed_tokens

    @property
    def spec_tokens_per_step(self) -> float:
        """Mean tokens committed a target pass a decoding slot (plain
        decode: 1.0; the all-accept round: k + 1)."""
        if not self.spec_slot_steps:
            return 0.0
        return self.spec_emitted_tokens / self.spec_slot_steps

    @property
    def draft_time_ms_p50(self) -> float:
        return percentile(self.draft_time_ms, 50)

    @property
    def draft_time_ms_p95(self) -> float:
        return percentile(self.draft_time_ms, 95)

    @property
    def draft_time_ms_p99(self) -> float:
        return percentile(self.draft_time_ms, 99)

    @property
    def spec_path_depth_p50(self) -> float:
        return percentile(self.spec_path_depth, 50)

    @property
    def spec_path_depth_p95(self) -> float:
        return percentile(self.spec_path_depth, 95)

    @property
    def spec_path_depth_p99(self) -> float:
        return percentile(self.spec_path_depth, 99)

    @property
    def spec_branch_utilization(self) -> float:
        """Fraction of slot-rounds whose accepted path used a sibling
        branch (left the draft's sampled chain): the rounds where the tree
        beat what the chain alone would have accepted.  0.0 under chain
        rounds."""
        if not self.spec_slot_steps:
            return 0.0
        return self.spec_branch_hits / self.spec_slot_steps

    @property
    def prefix_cache_hit_rate(self) -> float:
        """Fraction of admission lookups that matched a cached prefix."""
        if not self.prefix_lookups:
            return 0.0
        return self.prefix_hits / self.prefix_lookups

    @property
    def pool_utilization(self) -> float:
        if not self.kv_pool_blocks:
            return 0.0
        return self.peak_blocks_used / self.kv_pool_blocks

    @property
    def blocks_per_token(self) -> float:
        """Mean pool positions held per live token across decode steps
        (>= 1.0 without sharing; the excess is partial-tail-block waste,
        shared prefix blocks pull it down)."""
        if not self.token_slot_steps:
            return 0.0
        return (self.block_slot_steps * self.kv_block_size
                / self.token_slot_steps)

    def phase_util(self) -> Dict[str, Dict[str, float]]:
        """Per-phase achieved MFU / MBU from the engine's own counters: each
        phase's (busy time, token positions, weight passes, KV positions
        attended) joined with the per-token constants the engine stamps at
        construction (`analysis/roofline.py`): useful FLOPs =
        flops_per_token * positions; HBM bytes = weight bytes * passes +
        KV bytes a token * attended positions.  Phases: "prefill" (whole
        prompts, chunks and recomputes), then "verify" under speculation
        or "decode" otherwise, and "encode".  {} when the FLOP constant is
        unknown (stats built outside an engine)."""
        if not self.model_flops_per_token:
            return {}
        from repro_torch.analysis.roofline import utilization
        wbytes = float(self.weight_bytes_per_device)

        def row(time_s, tokens, passes, kv_positions):
            flops = self.model_flops_per_token * tokens
            hbm = wbytes * passes + self.kv_bytes_per_token * kv_positions
            mfu, mbu = utilization(flops, hbm, time_s)
            return {"time_s": time_s, "tokens": float(tokens),
                    "passes": float(passes),
                    "kv_positions": float(kv_positions),
                    "flops": flops, "hbm_bytes": hbm,
                    "mfu": mfu, "mbu": mbu}

        out: Dict[str, Dict[str, float]] = {}
        pre_t = self.nar_time_s + self.recompute_time_s
        if pre_t > 0:
            out["prefill"] = row(
                pre_t, self.padded_nar_tokens + self.recompute_tokens,
                self.prefill_batches + self.prefill_chunks,
                self.nar_tokens + self.recompute_tokens)
        if self.ar_time_s > 0:
            if self.spec_rounds:
                out["verify"] = row(self.ar_time_s, self.verify_positions,
                                    self.spec_rounds, self.token_slot_steps)
            else:
                out["decode"] = row(self.ar_time_s, self.ar_tokens,
                                    self.decode_steps, self.token_slot_steps)
        if self.encode_time_s > 0:
            out["encode"] = row(self.encode_time_s,
                                self.padded_encode_tokens,
                                self.encode_batches, 0)
        return out

    def to_dict(self) -> dict:
        """JSON-ready snapshot, in the reference's keys."""
        return {
            "batch_size": self.batch_size,
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "nar_tokens": self.nar_tokens,
            "padded_nar_tokens": self.padded_nar_tokens,
            "nar_time_s": self.nar_time_s,
            "nar_tok_s": self.nar_tok_s,
            "ar_tokens": self.ar_tokens,
            "ar_time_s": self.ar_time_s,
            "ar_tok_s": self.ar_tok_s,
            "decode_steps": self.decode_steps,
            "slot_occupancy": self.slot_occupancy,
            "padding_overhead": self.padding_overhead,
            "encode_tokens": self.encode_tokens,
            "padded_encode_tokens": self.padded_encode_tokens,
            "encode_time_s": self.encode_time_s,
            "encode_tok_s": self.encode_tok_s,
            "encode_batches": self.encode_batches,
            "encode_compiles": self.encode_compiles,
            "encode_completed": self.encode_completed,
            **{f"encode_latency_{k}_ms": v
               for k, v in percentiles(self.encode_latency_ms).items()},
            "prefill_batches": self.prefill_batches,
            "prefill_chunks": self.prefill_chunks,
            "chunked_prefill_tokens": self.chunked_prefill_tokens,
            "spec_rounds": self.spec_rounds,
            "spec_proposed_tokens": self.spec_proposed_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_emitted_tokens": self.spec_emitted_tokens,
            "spec_acceptance_rate": self.spec_acceptance_rate,
            "spec_tokens_per_step": self.spec_tokens_per_step,
            "spec_draft_time_s": self.spec_draft_time_s,
            "verify_positions": self.verify_positions,
            **{f"draft_time_ms_{k}": v
               for k, v in percentiles(self.draft_time_ms).items()},
            "spec_tree_nodes": self.spec_tree_nodes,
            "spec_branch_hits": self.spec_branch_hits,
            "spec_branch_utilization": self.spec_branch_utilization,
            **{f"spec_path_depth_{k}": v
               for k, v in percentiles(self.spec_path_depth).items()},
            **{f"ttft_{k}_ms": v for k, v in percentiles(self.ttft_ms).items()},
            "slo_requests": self.slo_requests,
            "slo_met": self.slo_met,
            "slo_attainment": self.slo_attainment,
            "requests_shed": self.requests_shed,
            "requests_degraded": self.requests_degraded,
            **{f"ttft_slo_ratio_{k}": v
               for k, v in percentiles(self.ttft_slo_ratio).items()},
            **{f"tpot_{k}_ms": v
               for k, v in percentiles(self.tpot_ms_samples).items()},
            "overlapped_steps": self.overlapped_steps,
            "overlap_host_s": self.overlap_host_s,
            "host_overlap_ratio": self.host_overlap_ratio,
            **{f"queue_wait_{k}_ms": v
               for k, v in percentiles(self.queue_wait_ms).items()},
            **{f"decode_step_{k}_ms": v
               for k, v in percentiles(self.decode_step_ms).items()},
            **{f"decode_stall_{k}_ms": v
               for k, v in percentiles(self.decode_stall_ms).items()},
            "bucket_hits": {str(k): v
                            for k, v in sorted(self.bucket_hits.items())},
            "prefill_compiles": self.prefill_compiles,
            "kv_pool_blocks": self.kv_pool_blocks,
            "kv_block_size": self.kv_block_size,
            "peak_blocks_used": self.peak_blocks_used,
            "pool_utilization": self.pool_utilization,
            "blocks_per_token": self.blocks_per_token,
            "preemptions": self.preemptions,
            "recompute_tokens": self.recompute_tokens,
            "recompute_time_s": self.recompute_time_s,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_cache_hit_rate": self.prefix_cache_hit_rate,
            "cached_prefix_tokens": self.cached_prefix_tokens,
            "cached_blocks": self.cached_blocks,
            "evicted_blocks": self.evicted_blocks,
            "cow_copies": self.cow_copies,
            "weight_dtype": self.weight_dtype,
            "kv_dtype": self.kv_dtype,
            "weight_bytes_per_device": self.weight_bytes_per_device,
            "kv_pool_bytes": self.kv_pool_bytes,
            "model_flops_per_token": self.model_flops_per_token,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "phase_util": self.phase_util(),
        }

    def summary(self) -> str:
        enc = ""
        if self.encode_batches:
            enc = (f" | ENC {self.encode_tok_s:8.1f} tok/s "
                   f"({self.encode_completed} reqs, p95 "
                   f"{self.encode_latency_p95_ms:.0f}ms)")
        chunk = ""
        if self.prefill_chunks:
            chunk = (f" | chunked {self.chunked_prefill_tokens} tok in "
                     f"{self.prefill_chunks} chunks, decode-stall p95 "
                     f"{self.decode_stall_p95_ms:.0f}ms")
        prefix = ""
        if self.prefix_lookups:
            prefix = (f" | PREFIX {self.prefix_cache_hit_rate:.0%} hit, "
                      f"{self.cached_prefix_tokens} tok reused, "
                      f"{self.cow_copies} COW, "
                      f"{self.evicted_blocks} evicted")
        spec = ""
        if self.spec_rounds:
            tree = ""
            if self.spec_tree_nodes:
                tree = (f", tree {self.spec_tree_nodes} nodes, path p50 "
                        f"{self.spec_path_depth_p50:.1f} p95 "
                        f"{self.spec_path_depth_p95:.1f}, branch "
                        f"{self.spec_branch_utilization:.0%}")
            spec = (f" | SPEC {self.spec_acceptance_rate:.0%} accept, "
                    f"{self.spec_tokens_per_step:.2f} tok/step, draft p95 "
                    f"{self.draft_time_ms_p95:.1f}ms" + tree)
        quant = ""
        if self.weight_dtype != "bfloat16" or self.kv_dtype != "bfloat16":
            quant = (f" | QUANT w={self.weight_dtype} kv={self.kv_dtype}, "
                     f"params {self.weight_bytes_per_device / 2**20:.1f}MiB, "
                     f"pool {self.kv_pool_bytes / 2**20:.1f}MiB")
        slo = ""
        if self.slo_requests or self.requests_shed:
            r = percentiles(self.ttft_slo_ratio)
            slo = (f" | SLO {self.slo_attainment:.0%} met "
                   f"({self.slo_met}/{self.slo_requests}, "
                   f"ttft/deadline p50 {r['p50']:.2f} p99 {r['p99']:.2f}), "
                   f"{self.requests_shed} shed, "
                   f"{self.requests_degraded} degraded")
        ovl = ""
        if self.overlapped_steps:
            ovl = (f" | OVERLAP {self.overlapped_steps} steps, "
                   f"{self.host_overlap_ratio:.0%} host hidden")
        return (f"NAR {self.nar_tok_s:8.1f} tok/s ({self.nar_tokens} prompt "
                f"tokens, {self.padding_overhead:.0%} pad) | "
                f"AR {self.ar_tok_s:8.1f} tok/s ({self.ar_tokens} tokens, "
                f"occupancy {self.slot_occupancy:.0%}) | "
                f"TTFT p50 {self.ttft_p50_ms:.0f}ms p95 "
                f"{self.ttft_p95_ms:.0f}ms | KV pool peak "
                f"{self.pool_utilization:.0%} ({self.peak_blocks_used}/"
                f"{self.kv_pool_blocks} x {self.kv_block_size}-token blocks, "
                f"{self.blocks_per_token:.2f} positions a live token, "
                f"{self.preemptions} preempt)" + enc + chunk + spec
                + prefix + quant + slo + ovl)

"""Serving telemetry (subset of the reference's serving/stats.py): the
paper's NAR / AR split, the encode (EncodeTask) side, TTFT, decode-step and
encode latency percentiles, length bucket hits, preemptions and KV pool
use, the storage dtypes and resident bytes of the weights and KV caches
(the `QUANT` part of the summary under int8), and the step builds.  The
port's prefill and encode steps run eagerly
(`launch/steps.py`); `prefill_compiles` / `encode_compiles` count the
distinct step callables built, as the reference counts its compiled steps.
The decode step is built once per runner, and on a card captured in one
CUDA graph."""
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
    # -- serving-level ------------------------------------------------------
    ttft_ms: List[float] = field(default_factory=Reservoir)
    queue_wait_ms: List[float] = field(default_factory=Reservoir)
    tpot_ms_samples: List[float] = field(default_factory=Reservoir)
    bucket_hits: Dict[int, int] = field(default_factory=dict)
    # -- paged KV pool ------------------------------------------------------
    kv_pool_blocks: int = 0
    kv_block_size: int = 0
    peak_blocks_used: int = 0
    preemptions: int = 0
    recompute_tokens: int = 0
    recompute_time_s: float = 0.0
    # -- storage --------------------------------------------------------------
    weight_dtype: str = "bfloat16"  # GEMM weight storage ("int8" = quantized)
    kv_dtype: str = "bfloat16"      # paged-pool storage ("int8" = quantized)
    weight_bytes_per_device: int = 0  # resident parameter bytes
    kv_pool_bytes: int = 0            # resident decode-cache bytes

    def add_ttft_ms(self, v: float) -> None:
        self.ttft_ms.add(v)

    def add_decode_step_ms(self, v: float) -> None:
        self.decode_step_ms.add(v)

    def add_queue_wait_ms(self, v: float) -> None:
        self.queue_wait_ms.add(v)

    def add_tpot_ms(self, v: float) -> None:
        self.tpot_ms_samples.add(v)

    def add_encode_latency_ms(self, v: float) -> None:
        self.encode_latency_ms.add(v)

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
    def decode_step_p50_ms(self) -> float:
        return percentile(self.decode_step_ms, 50)

    @property
    def decode_step_p95_ms(self) -> float:
        return percentile(self.decode_step_ms, 95)

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
    def pool_utilization(self) -> float:
        if not self.kv_pool_blocks:
            return 0.0
        return self.peak_blocks_used / self.kv_pool_blocks

    def to_dict(self) -> dict:
        return {
            "batch_size": self.batch_size,
            "requests_submitted": self.requests_submitted,
            "requests_completed": self.requests_completed,
            "nar_tokens": self.nar_tokens,
            "padded_nar_tokens": self.padded_nar_tokens,
            "nar_time_s": self.nar_time_s,
            "nar_tok_s": self.nar_tok_s,
            "prefill_batches": self.prefill_batches,
            "prefill_compiles": self.prefill_compiles,
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
            **{f"ttft_{k}_ms": v for k, v in percentiles(self.ttft_ms).items()},
            **{f"decode_step_{k}_ms": v
               for k, v in percentiles(self.decode_step_ms).items()},
            **{f"queue_wait_{k}_ms": v
               for k, v in percentiles(self.queue_wait_ms).items()},
            **{f"tpot_{k}_ms": v
               for k, v in percentiles(self.tpot_ms_samples).items()},
            "bucket_hits": {str(k): v
                            for k, v in sorted(self.bucket_hits.items())},
            "kv_pool_blocks": self.kv_pool_blocks,
            "kv_block_size": self.kv_block_size,
            "peak_blocks_used": self.peak_blocks_used,
            "pool_utilization": self.pool_utilization,
            "preemptions": self.preemptions,
            "recompute_tokens": self.recompute_tokens,
            "recompute_time_s": self.recompute_time_s,
            "weight_dtype": self.weight_dtype,
            "kv_dtype": self.kv_dtype,
            "weight_bytes_per_device": self.weight_bytes_per_device,
            "kv_pool_bytes": self.kv_pool_bytes,
        }

    def summary(self) -> str:
        enc = ""
        if self.encode_batches:
            enc = (f" | ENC {self.encode_tok_s:8.1f} tok/s "
                   f"({self.encode_completed} reqs, p95 "
                   f"{self.encode_latency_p95_ms:.0f}ms)")
        quant = ""
        if self.weight_dtype != "bfloat16" or self.kv_dtype != "bfloat16":
            quant = (f" | QUANT w={self.weight_dtype} kv={self.kv_dtype}, "
                     f"params {self.weight_bytes_per_device / 2**20:.1f}MiB, "
                     f"pool {self.kv_pool_bytes / 2**20:.1f}MiB")
        return (f"NAR {self.nar_tok_s:8.1f} tok/s ({self.nar_tokens} prompt "
                f"tokens, {self.padding_overhead:.0%} pad) | "
                f"AR {self.ar_tok_s:8.1f} tok/s ({self.ar_tokens} tokens, "
                f"occupancy {self.slot_occupancy:.0%}) | "
                f"TTFT p50 {self.ttft_p50_ms:.0f}ms p95 "
                f"{self.ttft_p95_ms:.0f}ms | KV pool peak "
                f"{self.pool_utilization:.0%} ({self.peak_blocks_used}/"
                f"{self.kv_pool_blocks} x {self.kv_block_size}-token blocks, "
                f"{self.preemptions} preempt)" + enc + quant)

"""Serving driver of the port: a mixed-length request trace through
`InferenceEngine` (port of the reference's launch/serve.py).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-j \\
        --reduced --device cpu --requests 6 --batch 2 --prompt-len 32 \\
        --min-prompt-len 8 --max-new 6 --temperature 0.7 --top-k 40

Runs on the GPU unless `--device cpu` is given.  Reports the paper's two
serving metrics from `engine.stats()`: NAR prompt-encoding throughput and
AR decode throughput (tokens/s, counted from true per-request prompt
lengths, not padded buckets), plus TTFT percentiles, decode-slot
occupancy, the KV pool's peak use and prefill bucket hits; `--task encode`
sends EncodeTasks (pooled embeddings) instead.

Only what the port serves has a flag: the synchronous or overlapped loop
(`--overlap`: the next decode step dispatched before the previous step's
tokens are fetched; token-identical) under the FCFS, priority,
chunked-prefill or deadline policy (`--policy`, `--prefill-chunk`;
`--deadline-ms` stamps a TTFT budget on every request, which the deadline
policy schedules on, sheds by and scores SLO attainment against),
the prefix cache (on by default, as in the reference: `--no-prefix-cache`
turns it off, `--cache-blocks` caps its index), greedy and sampled
decoding, the paged KV pool, the encode mode, int8 serving
(`--weight-dtype int8`: the dense GEMM weights quantized once per output
channel; `--kv-dtype int8`: the paged KV pools quantized on write, a scale
a block and kv head; the summary then adds a QUANT part) and speculative
decoding (`--spec-draft self | auto | <config>-draft`, `--spec-k`, and
`--spec-branches` > 1 for token trees; the summary adds a SPEC part and
two spec lines follow it).  A config that cannot chunk or cache (SSM
state, ring caches, a VLM's patch prefix) prefills whole prompts and the
CLI prints why; one that cannot speculate (the same state, or a patch
prefix) is refused with the reason before any weight is made.  A VLM
(internvl2-76b) serves its backbone behind zero patch rows
(`models/frontends.py`), which take n_patches positions of every
sequence.  A config whose bf16 weights exceed the device's memory
(mixtral-8x7b at full size: 93.4 GB, deepseek-67b 134.9 GB, internvl2-76b
141.1 GB, against an 80 GB card) is refused before any weight is made;
`--reduced` serves it.  The CLI serves whole configs only.
Observability: `--trace-out PATH` records a Chrome trace-event JSON of the
run (`serving/trace.py`; `--trace-buffer` events at most, the oldest
dropped), `--metrics-out PATH` writes a Prometheus text snapshot of the
final stats; the summary adds a `util:` line of each phase's MFU / MBU
against the H100's peaks.  `--draft-checkpoint DIR` loads the draft's
params from a checkpoint directory (`checkpoint/checkpointer.py`, either
package's) instead of a seeded init; it needs `--spec-draft`.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serving import (EncodeTask, InferenceEngine, Request,
                                 SamplingParams, SpecConfig, Tracer,
                                 make_policy, prometheus_text)
from repro_torch.serving.spec import spec_support_reason


def build_trace(cfg, args) -> list:
    """Mixed-length request trace; lengths uniform in
    [min_prompt_len, prompt_len] (fixed-length when min == max).
    --task encode emits EncodeTasks (pooled embeddings) instead.  Every
    request carries the --deadline-ms budget (0: none)."""
    rng = np.random.default_rng(args.seed)
    lo = args.min_prompt_len or args.prompt_len
    deadline = args.deadline_ms or None
    reqs = []
    for uid in range(args.requests):
        n = int(rng.integers(lo, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, n, dtype=np.int32)
        if args.task == "encode":
            reqs.append(EncodeTask(uid=uid, prompt=prompt,
                                   pooling=args.pooling,
                                   deadline_ms=deadline))
            continue
        sampling = (SamplingParams(temperature=args.temperature,
                                   top_k=args.top_k, seed=uid)
                    if args.temperature > 0 else SamplingParams())
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.max_new,
                            deadline_ms=deadline, sampling=sampling))
    return reqs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a seeded request trace through the port's "
                    "InferenceEngine.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length")
    ap.add_argument("--min-prompt-len", type=int, default=0,
                    help="min prompt length (0 => fixed at --prompt-len)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 => greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--policy",
                    choices=("fcfs", "priority", "chunked", "deadline"),
                    default="fcfs", help="scheduling policy")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped host loop: dispatch the next decode "
                         "step before fetching the previous step's tokens "
                         "(token-identical to the sync loop)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request TTFT SLO budget in ms (0 = no "
                         "deadline); pairs with --policy deadline")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="chunked prefill token budget (--policy chunked)")
    ap.add_argument("--task", choices=("generate", "encode"),
                    default="generate",
                    help="generate: AR decode requests; encode: "
                         "encoder-only pooled-embedding requests")
    ap.add_argument("--pooling", choices=("last", "mean"), default="last",
                    help="EncodeTask pooling (--task encode)")
    ap.add_argument("--spec-draft", default="",
                    help="speculative decoding draft: 'self', 'auto', or a "
                         "registered draft config name (empty = off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="speculation length: draft tokens proposed per "
                         "verify step (--spec-draft)")
    ap.add_argument("--draft-checkpoint", default="",
                    help="checkpoint directory to load draft params from "
                         "(default: seeded init; requires --spec-draft)")
    ap.add_argument("--spec-branches", type=int, default=1,
                    help="token-tree width: candidates proposed per "
                         "speculation depth (1 = single-chain rounds)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block size (tokens)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="KV pool capacity in blocks (0 => engine default); "
                         "undersize it to exercise preemption")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share cached prompt-prefix KV blocks across "
                         "requests (serving/prefix_cache.py); "
                         "--no-prefix-cache restores cold prefills")
    ap.add_argument("--cache-blocks", type=int, default=0,
                    help="cap on pool blocks the prefix-cache index may "
                         "hold (0 => bounded by pool pressure alone)")
    ap.add_argument("--weight-dtype", choices=("bfloat16", "int8"),
                    default="bfloat16",
                    help="GEMM weight storage: int8 quantizes per output "
                         "channel once at startup (models/quantize.py) and "
                         "applies the scale in the fused GEMMs' fp32 "
                         "accumulator")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"),
                    default="bfloat16",
                    help="paged KV pool storage: int8 quantizes on write "
                         "with per-block-per-head scales (ring caches keep "
                         "the activation dtype)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(Perfetto-viewable); empty = tracing off")
    ap.add_argument("--trace-buffer", type=int, default=65536,
                    help="tracer ring-buffer capacity in events "
                         "(oldest dropped beyond it)")
    ap.add_argument("--metrics-out", default="",
                    help="write a Prometheus-style text snapshot of the "
                         "final stats (empty = off)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the fused prologue/epilogue GEMM "
                         "pipeline (A/B parity baseline)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def config_of(args):
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def device_memory_bytes(device) -> int:
    """Memory of the device the engine fills: the card's total memory, or
    the host's physical memory for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def fit_reason(cfg, device):
    """Why `cfg`'s bf16 weights cannot be made on `device` (None when they
    fit): their bytes against the device's memory, before any is made."""
    need, have = 2 * cfg.n_params(), device_memory_bytes(device)
    if need <= have:
        return None
    return (f"{cfg.name}: its bf16 weights are {need / 1e9:.1f} GB, more "
            f"than the {have / 1e9:.1f} GB of {resolve_device(device)}; "
            f"serve it with --reduced")


def run(args):
    """Build the engine from `args` (seeded bf16 weights), serve the trace.
    -> (engine, completed tasks, wall seconds)."""
    cfg = config_of(args)
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=args.device,
                        seed=args.seed)
    spec = (SpecConfig(draft=args.spec_draft, k=args.spec_k,
                       branches=args.spec_branches)
            if args.spec_draft else None)
    tracer = Tracer(capacity=args.trace_buffer) if args.trace_out else None
    engine = InferenceEngine(
        cfg, params, batch_size=args.batch, max_seq=args.max_seq,
        block_size=args.block_size,
        kv_pool_blocks=args.kv_pool_blocks or None,
        scheduler=make_policy(args.policy, chunk_tokens=args.prefill_chunk,
                              cache_aware=args.prefix_cache),
        fuse_epilogues=not args.no_fuse, weight_dtype=args.weight_dtype,
        kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
        cache_blocks=args.cache_blocks or None, spec=spec,
        draft_checkpoint=args.draft_checkpoint or None,
        device=args.device, overlap=args.overlap, tracer=tracer)
    if args.policy == "chunked" and not engine.runner.supports_chunked:
        print(f"note: {cfg.name} cannot chunk prefills "
              f"({engine.runner.chunk_unsupported_reason}) — "
              f"falling back to whole-prompt admission")
    if args.prefix_cache and engine.prefix_cache is None:
        print(f"note: prefix cache disabled for {cfg.name} — "
              f"{engine.runner.prefix_cache_reason}")
    for req in build_trace(cfg, args):
        engine.submit(req)
    t0 = time.perf_counter()
    done = engine.run()
    return engine, done, time.perf_counter() - t0


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.min_prompt_len > args.prompt_len:
        ap.error(f"--min-prompt-len {args.min_prompt_len} exceeds "
                 f"--prompt-len {args.prompt_len}")
    if not (math.isfinite(args.deadline_ms) and args.deadline_ms >= 0):
        ap.error(f"--deadline-ms must be a finite budget >= 0 (0: none): "
                 f"{args.deadline_ms}")
    if args.trace_buffer < 1:
        ap.error(f"--trace-buffer must be >= 1: {args.trace_buffer}")
    cfg = config_of(args)
    reason = fit_reason(cfg, args.device)
    if reason:
        ap.error(reason)
    if args.draft_checkpoint and not args.spec_draft:
        ap.error("--draft-checkpoint requires --spec-draft")
    if args.spec_draft and spec_support_reason(cfg):
        ap.error(f"speculative decoding unsupported for {cfg.name}: "
                 f"{spec_support_reason(cfg)}")
    engine, done, wall = run(args)
    stats = engine.stats()
    step = engine.runner.decode_step
    print(f"served {len(done)} requests in {wall:.2f}s over "
          f"{stats.decode_steps} AR steps [policy={args.policy}"
          f"{', overlap' if args.overlap else ''}, device="
          f"{engine.runner.device}, decode step "
          f"{'captured' if step.aux['captured'] else 'eager'}] "
          f"({stats.prefill_compiles} prefill buckets compiled: "
          f"{sorted(stats.bucket_hits)})")
    print(stats.summary())
    runner = engine.runner
    if runner.spec is not None:
        print(f"  spec: draft={runner.draft_cfg.name} k={runner.spec.k}"
              f" | {stats.spec_acceptance_rate:.0%} of "
              f"{stats.spec_proposed_tokens} proposals accepted, "
              f"{stats.spec_tokens_per_step:.2f} tokens/target-step, "
              f"draft p50 {stats.draft_time_ms_p50:.1f}ms p95 "
              f"{stats.draft_time_ms_p95:.1f}ms")
        if runner.tree_branches > 1:
            print(f"  tree: b={runner.tree_branches} | "
                  f"{stats.spec_tree_nodes} nodes verified, accepted-path "
                  f"depth p50 {stats.spec_path_depth_p50:.1f} p95 "
                  f"{stats.spec_path_depth_p95:.1f}, branch utilization "
                  f"{stats.spec_branch_utilization:.0%}")
    util = stats.phase_util()
    if util:
        print("  util: " + " | ".join(
            f"{ph} MFU {row['mfu']:.2%} MBU {row['mbu']:.2%} "
            f"({row['time_s'] * 1e3:.0f}ms)"
            for ph, row in util.items()))
    tracer = engine.tracer
    if tracer is not None:
        n_ev = tracer.write(args.trace_out)
        print(f"  trace: {n_ev} events -> {args.trace_out} "
              f"({tracer.dropped} dropped; open at https://ui.perfetto.dev)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(prometheus_text(stats.to_dict()))
        print(f"  metrics: -> {args.metrics_out}")
    for r in sorted(done, key=lambda r: r.uid)[:3]:
        if isinstance(r, EncodeTask):
            e = np.asarray(r.embedding)
            print(f"  enc {r.uid}: prompt {r.prompt_len} (bucket "
                  f"{r.bucket}), {r.encode_ms:.0f}ms, |emb|="
                  f"{float(np.linalg.norm(e)):.3f} [{e[0]:+.4f} "
                  f"{e[1]:+.4f} ...]")
        else:
            print(f"  req {r.uid}: prompt {r.prompt_len} (bucket "
                  f"{r.bucket}), prefill {r.prefill_ms:.0f}ms, "
                  f"{len(r.output)} tokens, first: {r.output[:8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

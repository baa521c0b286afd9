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

Only what the port serves has a flag: the FCFS synchronous loop, greedy
and sampled decoding, the paged KV pool, the encode mode and int8 serving
(`--weight-dtype int8`: the dense GEMM weights quantized once per output
channel; `--kv-dtype int8`: the paged KV pools quantized on write, a scale
a block and kv head; the summary then adds a QUANT part).  The reference's
flags for unported features (speculation, the prefix cache, the overlapped
loop, other scheduling policies, tracing and metrics export) do not exist
here, and argparse refuses them.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import (EncodeTask, InferenceEngine, Request,
                                 SamplingParams)


def build_trace(cfg, args) -> list:
    """Mixed-length request trace; lengths uniform in
    [min_prompt_len, prompt_len] (fixed-length when min == max).
    --task encode emits EncodeTasks (pooled embeddings) instead."""
    rng = np.random.default_rng(args.seed)
    lo = args.min_prompt_len or args.prompt_len
    reqs = []
    for uid in range(args.requests):
        n = int(rng.integers(lo, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, n, dtype=np.int32)
        if args.task == "encode":
            reqs.append(EncodeTask(uid=uid, prompt=prompt,
                                   pooling=args.pooling))
            continue
        sampling = (SamplingParams(temperature=args.temperature,
                                   top_k=args.top_k, seed=uid)
                    if args.temperature > 0 else SamplingParams())
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=args.max_new, sampling=sampling))
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
    ap.add_argument("--task", choices=("generate", "encode"),
                    default="generate",
                    help="generate: AR decode requests; encode: "
                         "encoder-only pooled-embedding requests")
    ap.add_argument("--pooling", choices=("last", "mean"), default="last",
                    help="EncodeTask pooling (--task encode)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV pool block size (tokens)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="KV pool capacity in blocks (0 => engine default); "
                         "undersize it to exercise preemption")
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
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the fused prologue/epilogue GEMM "
                         "pipeline (A/B parity baseline)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args):
    """Build the engine from `args` (seeded bf16 weights), serve the trace.
    -> (engine, completed tasks, wall seconds)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=args.device,
                        seed=args.seed)
    engine = InferenceEngine(
        cfg, params, batch_size=args.batch, max_seq=args.max_seq,
        block_size=args.block_size,
        kv_pool_blocks=args.kv_pool_blocks or None,
        fuse_epilogues=not args.no_fuse, weight_dtype=args.weight_dtype,
        kv_dtype=args.kv_dtype, device=args.device)
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
    engine, done, wall = run(args)
    stats = engine.stats()
    step = engine.runner.decode_step
    print(f"served {len(done)} requests in {wall:.2f}s over "
          f"{stats.decode_steps} AR steps [policy=fcfs, device="
          f"{engine.runner.device}, decode step "
          f"{'captured' if step.aux['captured'] else 'eager'}] "
          f"({stats.prefill_compiles} prefill buckets compiled: "
          f"{sorted(stats.bucket_hits)})")
    print(stats.summary())
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

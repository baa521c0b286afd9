"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints its results; any failure raises and the exit code is
non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch / CUDA /
              nvcc versions;
  2. build    nvcc builds every kernel from src/repro_torch/kernels/csrc, one
              process per source, all started together;
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, in bf16, at the serving shapes of GPT-J / GPT3-XL
              (MHA), phi4-mini (SwiGLU, RMSNorm, GQA 24 / 8), hymba-1.5b
              (SSD 64 heads x 64 x 16, also with fp32 operands; residual
              RMSNorm at d_model 1600, also cold in L2, and its other dtype
              pairs and looped path; flash attention at 25 / 5 x 64),
              mamba2-2.7b (SSD 80 heads x 64 x 128, also fp32), ViT-B and
              ViT-H (bidirectional flash attention, 197 tokens at 12 x 64
              and 16 x 80, also 257 at 16 x 80; the GEMMs of a batch-8
              pass at ViT-B / L / H widths and the 1000-class head on
              both GEMM templates; LayerNorm at 768 / 1024 / 1280, and
              2048 for GPT3-XL's encode pooling), a causal chunk with a
              query offset, and gemma3-27b (flash attention with a 1024 window;
              dense decode over 1024-slot rings at GQA 32 / 16 and hymba's
              25 / 5, over a linear 2048 cache with the window, and over
              the speculative drafts' linear 512-row caches at GPT-J's
              16 x 256 and phi4-mini's 24 / 8 x 128, each held to the
              plain version at the kernel's split count and to the TPU
              kernel's walk); the paged decode's partials at 1, 2
              and 4 splits of the table, also over GPT-J's serving batch
              (lengths 200-332) and over 17 slots, where the normalized
              wrapper runs one split; the plain norms at widths 3072, 2560
              and 1600: the error against the stated tolerance, kernel /
              plain / library milliseconds (CUDA events, median of the
              timed launches) and the bound (the larger of bytes / 3.35
              TB/s and FLOPs / 989 TFLOP/s, the H100 SXM data-sheet
              peaks); the fused GEMMs also at gemma3's widths, hymba's
              SwiGLU and ragged M (9, 17, 1100), with the template the
              planner took; device times of the kernel and of its library
              call (torch.profiler kernel events, no host time) for every
              kernel, and the plain norms' host time a call; decode GEMM
              cases rotate weight copies past the 50 MB L2; then the int8
              forms (int8 serving): both fused GEMMs with int8 weights and
              their column scales (GPT-J's projections at M = 4 and 512,
              its head, phi4-mini's head and gated up-projection: the
              stream and wgmma templates, K split) and the paged decode
              over int8 pools with per-(block, kv head) scales (GPT-J's
              serving batch, phi4-mini's GQA: the partials at 1, 2 and 4
              splits, the normalized wrapper), each against its plain
              version on the same int8 operands, beside one bf16
              torch.matmul / SDPA call at the shape and a bound that
              counts int8 bytes;
  4. sampling threefry Gumbel noise drawn on the card against the same draw
              on the CPU: bits, uniforms and noise bit-equal, sampled
              tokens identical;
  5. serve    GPT-J, phi4-mini, hymba-1.5b, mamba2-2.7b, then GPT3-XL
              with 4 EncodeTasks (pooling last and mean) interleaved with
              its generate requests, at full width and depth (random seeded
              bf16 weights; hymba and mamba2 prefill at exact prompt
              lengths) behind
              InferenceEngine(batch_size=4, max_seq=512, block_size=16),
              then gemma3-27b (62 layers, 52 of them local) at max_seq
              2048, where its local layers keep ring caches, and hymba cut
              to 4 layers at max_seq 2048: 8 requests each (3 for the hymba
              leg), every kernel of the path launched (the dense decode
              kernel once per ring layer per decode step and never in
              prefill, the SSD kernel once per SSM layer per prefill pass,
              the residual RMSNorm once per hymba layer per prefill pass
              and decode step, flash once per attention layer per prefill
              or encode pass, the wgmma GEMMs once per prefill or encode
              pass, LayerNorm once per encode batch), no leaked blocks,
              each embedding held to a direct forward_encode on the plain
              path in bf16 and fp32; each engine captures its decode step
              in one CUDA graph at construction and every decode step is a
              replay of it (a replay adds the launch counts of the
              capture), the paged layers through the one paged route
              exactly once a step; a replay held to an eager
              forward_decode on cloned caches, tokens identical and caches
              bit-equal; the device's busy share
              of a decode step, its host launch calls (cudaGraphLaunch,
              cudaLaunchKernel), its largest kernels and host ops
              (torch.profiler), and for hymba and mamba2 of one 512-token
              prefill pass with the SSD kernels' share; then one prompt
              teacher-forced through the fused and the unfused kernel
              paths, final-position logits
              held to the plain (`ref`) path in bf16 and in fp32; then
              GPT-J and phi4-mini again with int8 weights and int8 KV
              (`weight_dtype="int8", kv_dtype="int8"`): every GEMM launch
              an int8 form and every paged launch the int8-pool form, the
              same graph, replay, leak and teacher-forced gates on the
              quantized weights, then a teacher-forced decode through
              the int8 KV pools held to the int8 plain path, and greedy
              flips of int8 against bf16 beside a noise-floor control
              (`flip_rule`); weight and KV bytes, AR / NAR tok/s, decode
              step and peak memory beside the bf16 runs;
     cli      `python -m repro_torch.launch.serve` (its `main`) at GPT-J
              full width: 6 sampled generate requests, 6 encodes, and the
              generate run again with `--weight-dtype int8 --kv-dtype
              int8` (int8 forms only), with `--policy chunked
              --prefill-chunk 32` and with `--spec-draft auto --spec-k 4
              --spec-branches 3` (the prefix cache on in every run, the
              CLI's default);
     chunk    GPT-J at full width and depth (`phase_chunk_prefix`): the
              serve trace under ChunkedPrefillPolicy(32) and under FCFS
              (exact launch counts with the chunk passes by width, the
              chunk partials once a layer a pass; the graph replay held to
              the eager step with a slot parked mid-prefill), a 300-token
              prompt teacher-forced in 32-token pieces against whole-prompt
              prefill; 8 requests sharing a 200-token prefix with the
              prefix cache on (hit rate >= 7/8, >= 7 x 192 reused tokens,
              copy-on-write of the shared tail block, the index's
              invariants, no leak after clear(), the replay held to the
              eager step after copies, a warm suffix pass teacher-forced
              against a cold prefill) and off, then with int8 weights and
              KV (int8 forms only, copies bit-equal with their scales);
              NAR tok/s, TTFT, decode-step and decode-stall p95 of each
              run; one chunk pass's wall, busy time and launches; the
              chunk partials op (torch on the device, no TPU kernel)
              against SDPA and its byte bound;
     spec     speculative decoding at full width and depth
              (`phase_spec`): a teacher-forced verify pass (k + 1 = 5 at
              pos0 200) held to five eager decode steps and to the plain
              path in bf16 / fp32 (floor-scaled gate and flip rule), its
              tree form on a width-3 tree bit-equal at the chain nodes,
              `sample_topn` card vs CPU with exact ties; engines on the
              serve trace: GPT-J draft="self" k 4, GPT-J with the
              mid-range draft (the target's first 2 layers, embedding
              and head mixed with 10% of another init) as a chain (k 4)
              and as a tree (k 3, width 3), GPT-J with int8 KV and width 3
              (falls back to the chain), phi4-mini with its mid-range
              draft: each served and drained, with exact launches (one
              chunk partials a layer a verify pass, its GEMMs on the
              template of M = B x C; each draft step one replay of the
              draft's captured graph, one dense decode a draft layer; no
              paged decode), each request's tokens against the same trace
              without speculation (a first divergence must be a near tie:
              the two tokens within 2 bf16 floors), the draft's replay
              held to its eager step, one verify pass and one draft step
              profiled; acceptance, tokens a target pass, verify
              positions, draft p50 / p95, branch utilization, AR tok/s
              beside the plain runs; then a forced sibling (a round's
              depth-1 chain token made wrong, the draft's token moved to a
              sibling): the sibling accepted, its KV row moved with
              row_copy, and the slot's next step held to a teacher-forced
              prefill of the committed tokens;
  6. vit      ViT-B, ViT-L and ViT-H at full width and depth, a batch of 8
              seeded images: the fused and unfused kernel paths with exact
              launch counts, logits held to the plain path in bf16 and
              fp32; images/s, the device's busy share of a pass and its
              largest kernels;
  7. witness  mamba2 at full width cut to 8 layers, where a random-init
              stack barely amplifies rounding: the kernel paths held to
              plain fp32 within 1.5 x the bf16 floor with no absolute
              minimum, and the fused path with the SSD kernel swapped for
              its plain version, to show the SSD kernel's share of the gap;
  8. ring     gemma3 at full width cut to one period (5 local, 1 global):
              a 1000-token prompt and 40 teacher-forced decode steps across
              position 1024, where the rings wrap; the kernel paths' logits
              at every step held to plain bf16 and fp32, and plain fp32
              decode (fp32 caches) held to exact-length prefill within 1e-4
              at positions 1010, 1023, 1024 and 1039;
  9. moe      mixtral-8x7b at full width cut to 16 of its 32 layers (46.9
              GB of bf16; the whole model's 93.4 GB do not fit), seeded:
              the serve trace through the fused engine (exact launches,
              the gated GEMM's expert form on the template each pass's
              expert capacity takes, the graph replay bit-equal to the
              eager step, decode profiles with the expert form's and the
              experts' cuBLAS down-projection's share), a shared-prefix
              trace chunked with the prefix cache, chain speculation (k 4)
              with mixtral-8x7b-draft; then a 4-layer witness, its routing
              pinned to the plain bf16 path's: logits held to plain bf16 /
              fp32, every routing disagreement a near tie.  The expert
              form itself is checked in the kernels phase (mixtral-8x7b
              decode C 2, prefill C 640, C 37; 8x22b decode), beside the
              router GEMM at N = 8 on both templates;
 10. dense    the remaining dense decoders at full width (`phase_dense`):
              chatglm3-6b whole (28 layers, GQA 32 / 2: the decode
              kernels' G = 16 form) through the serve checks above, a
              shared-prefix trace chunked with the prefix cache (the chunk
              stack at G = 16) and chain speculation (k 4) with
              chatglm3-6b-draft (the dense decode's G = 16 form in the
              draft's graph; a first divergence from plain decode must be
              a near tie); deepseek-67b cut to 30 of its 95 layers (44.9
              GB); internvl2-76b cut to 24 of its 80 layers (45.3 GB) at
              max_seq 1024, its prompts behind zero patch rows (the prompt
              cap and blocks count its 256-position prefix; the chunk
              policy, the prefix cache and speculation refused with the
              reference's reasons), its teacher-forced prompt behind
              seeded patches.  The kernels phase holds both decode kernels'
              G = 16 form (paged partials at 1, 2 and 4 splits, the
              normalized wrapper, the int8-pool form, the dense decode over
              the draft's 512-row cache), the fused GEMMs at these models'
              widths (M 4 and 512) and flash at H 32 / KV 2 and H 64 / KV 8;
 11. whisper  whisper-base at full size (6 encoder + 6 decoder layers,
              `phase_whisper`): the serve trace with 4 EncodeTasks (last
              and mean) through the fused engine, every prefill and encode
              pass running the encoder over 4 x 1504 zero frames and the
              decoder's cross-attention over its output (flash at Sq !=
              Skv, no mask), every decode step's cross step on the dense
              decode kernel over the cached 1504-row memory inside the
              captured graph, the sinusoidal positions indexed on the
              device; the serve gates above (exact launches, replay
              bit-equal to eager, no leak, teacher-forced logits behind
              seeded frames, encodes against the plain path); the
              encoder's share of a prefill pass; the unfused engine on the
              same trace; int8 weights and KV; the chunk policy, the
              prefix cache and speculation refused in the reference's
              words.  The kernels phase holds whisper's shapes: the fused
              GEMM at K 512 (M 6016 wgmma, M 4 stream, the 51968-column
              head), flash over 1504 frames and the cross call, the paged
              decode at 8 x 64, the dense decode over 1504 rows, LayerNorm
              at [6016, 512]; and times the norms' other dtype pairs and
              looped path and the paged decode at block sizes 8 / 32 and
              fp32 pools, each beside its library call and bound;
 12. goodput  GPT-J at full width and depth (`phase_goodput`): the serve
              trace synchronous, overlapped (DeadlinePolicy) and overlapped
              with the tracer (the slice's path): per-uid tokens and
              launches (by kernel and template) identical, overlapped steps
              and fast-path dispatches above 0, the host overlap ratio; a
              chained replay of the captured step bit-equal to a loaded
              one; the sync and overlapped engines' decode profiles (step
              wall against device busy); the trace written to
              chiprun_out/goodput_trace.json, read back schema-clean, its
              MFU / MBU (the H100's peaks) within 1% of the counters' and
              at most 1.05; an open-loop loadgen trace (64 requests at
              twice the sync run's req/s, a TTFT SLO of 24 requests' wait
              at that rate) through the
              overlapped engine under DeadlinePolicy, speculating with the
              2-layer mid-range draft: requests shed (each typed
              slo_unattainable) and degraded, every served request held to
              plain decode (`near_ties`); the CLI with --overlap --policy
              deadline --deadline-ms --trace-out --metrics-out, its trace
              validated by `python -m repro_torch.serving.trace` in a child
              process and its Prometheus text parsed.
13. train    training (`phase_train`): the kernels' autograd Functions
              (row 1's fused GEMM at M = 2048 as q / k / v with the LN
              prologue, w1 with LN + i-GELU, w2 with the residual and the
              fp32 CE head; row 3's flash causal at B 4 x 512 x 16 x 128
              and bidirectional at ViT-B's 197 x 12 x 64; row 8's
              LayerNorm at [2048, 2048]): every input's gradient on the
              card against torch.autograd through the plain version,
              forward + backward times beside F.linear / SDPA /
              F.layer_norm and the bound; a teacher gate at GPT3-XL width
              cut to 4 layers (one step under kernel mode cuda and ref:
              loss, grad norm and every leaf's gradient within max(5e-2, 2
              x the bf16 floor), launches exact: 13 GEMMs a layer + 2,
              flash 2 a layer, LayerNorm 1); GPT3-XL whole (40 layers, B 4
              x 512, bf16) through make_train_step: 12 steps on a repeated
              batch (the loss falling), step p50 / p95, tokens/s, MFU,
              peak GB, one step profiled (hand kernels against cuBLAS;
              the clip's and AdamW's device time by profiler range); the
              train CLI: GPT3-XL whole for 3 steps in a child process with
              one checkpoint (26.6 GB: the machine allows 45 GiB of writes
              a call), restored here and stepped bit for bit as the
              uninterrupted run, and the CLI's resume at --reduced size
              (the uninterrupted run through its `main` here, the resume
              in a child process);
              ViT-B's vit_loss fused and unfused, launches exact, held to
              plain bf16 by the teacher gate.
Every driven path zeroes the launch counters just before it and reads them
just after; a kernel of the path that never launched fails the run, and so
does a GEMM that ran the fp32-weight template (fma32) or a flash launch
that ran another template than wgmma on these bf16 paths; in each serve
run every GEMM of the layers (the plain `pdot` products included) must run
the wgmma template once a prefill pass and the stream template once a
decode step, launch for launch.  The
line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json,
each phase's seconds among them (`phase_seconds`, also printed).
"""
from __future__ import annotations

import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor FLOP/s (data sheet)
GEMM_TOL = {"bf16": 1e-2, "fp32": 1e-3}    # max|k - p| / max|p|
ATTN_TOL = 1e-2
NORM_TOL = 1e-2
SSD_TOL = {"y": 1e-2, "h": 1e-3}   # bf16 y; fp32 h_final (sum order only)
LOGIT_TOL = 5e-2              # teacher-forced head: max|dz| / max|z| ...
LOGIT_COS = 0.999             # ... or a multiple of the bf16 rounding floor
RING_EXACT_TOL = 1e-4         # fp32 ring decode vs exact-length prefill
L2_ROTATE_BYTES = 64 << 20    # decode GEMMs rotate weights past the 50 MB L2


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, flops):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def time_ms(fn, iters=20, warmup=3):
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, iters=200):
    """Mean wall time of one call over `iters` calls issued back to back and
    ended by one synchronize: where a call's device time is the shorter,
    the host's cost of a call (Python, checks, allocation, launch)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _rotate(fns):
    """One callable that runs `fns` in turn, call after call."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def device_ms(fns, iters=20):
    """Mean device time of one call: the CUDA kernels' time in a
    torch.profiler trace of `iters` calls (of `fns` in turn), per call; no
    host time between launches is counted.  None when two traces see no
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(2):        # a trace that caught no kernel is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        us = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    return None


def device_kernels(fn, iters=20):
    """{kernel name: (mean device ms a call, launches a call)} of `fn` over
    a torch.profiler trace of `iters` calls after one warm-up call: which
    kernels one call launches and what each takes."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key: (getattr(ev, "self_device_time_total", 0.0) / 1e3 / iters,
                     ev.count // iters)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def rel_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def row_rel_err(got, want):
    """(max|dz|, worst over the rows b of max|dz_b| / max|z_b|, that ratio
    for each row): each batch row is held to its own scale, so that a row
    of large values (length 1: a raw V row) does not loosen the others."""
    got, want = got.float(), want.float()
    B = got.shape[0]
    dz = (got - want).abs().reshape(B, -1).amax(1)
    per = (dz / want.abs().reshape(B, -1).amax(1).clamp(min=1e-30)).tolist()
    return dz.max().item(), max(per), per


def _ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _row(case, err, rel, tol, ms, plain, lib, nbytes, flops):
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(case=case, max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)


def _report(name, r, lib_name):
    dev = ""
    if "device_ms" in r:
        dev = (f" | device: kernel {_ms(r['device_ms'])} {lib_name} "
               f"{_ms(r['library_device_ms'])}")
        if r.get("template"):
            dev += f" [{r['template']}]"
    log(f"  {name} {r['case']:26s} rel err {r['rel_err']:.2e} (tol "
        f"{r['tol']:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
        f"ms {lib_name} {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}){dev}")
    if not r["rel_err"] <= r["tol"]:
        raise AssertionError(f"{name} {r['case']}: rel err {r['rel_err']} > "
                             f"{r['tol']}")


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    from repro_torch.kernels import build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | {nvcc} | "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": nvcc,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    records = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    secs = time.perf_counter() - t0
    log(f"build: {len(records)} nvcc runs in parallel, {secs:.1f} s")
    for r in records:
        for line in r["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"  ptxas[{r['name']}]: {line.strip()}")
    return {"seconds": secs,
            "logs": {r["name"]: r["log"] for r in records}}


# --------------------------------------------------------------------------
# 3. kernels vs plain versions
# --------------------------------------------------------------------------

def _gemm_cases():
    """(label, M, K, N, norm, activation, residual, out dtype): the GPT-J
    projections at decode batch (M=4) and a 512-token prefill, phi4-mini's
    projections and 200192-column logits head at decode batch, gemma3-27b's
    at decode batch (q, up, down, the 262144-column head), and ragged M —
    the first M past the stream template (9), 17 and gemma3's exact-length
    1100-token prefill — on gemma3's q projection."""
    out = []
    for M in (4, 512):
        out += [(f"qkv M={M}", M, 4096, 4096, "layernorm", "none", False,
                 torch.bfloat16),
                (f"mlp_up M={M}", M, 4096, 16384, "layernorm", "i_gelu",
                 False, torch.bfloat16),
                (f"mlp_down M={M}", M, 16384, 4096, "none", "none", True,
                 torch.bfloat16),
                (f"head M={M}", M, 4096, 50432, "layernorm", "none", False,
                 torch.float32)]
    out += [("phi4 q/o M=4", 4, 3072, 3072, "rmsnorm", "none", False,
             torch.bfloat16),
            ("phi4 k/v M=4", 4, 3072, 1024, "rmsnorm", "none", False,
             torch.bfloat16),
            ("phi4 w2 M=4", 4, 8192, 3072, "none", "none", True,
             torch.bfloat16),
            ("phi4 head M=4", 4, 3072, 200192, "rmsnorm", "none", False,
             torch.float32),
            ("gemma3 q M=4", 4, 5376, 4096, "rmsnorm", "none", False,
             torch.bfloat16),
            ("gemma3 up M=4", 4, 5376, 21504, "rmsnorm", "i_gelu", False,
             torch.bfloat16),
            ("gemma3 down M=4", 4, 21504, 5376, "none", "none", True,
             torch.bfloat16),
            ("gemma3 head M=4", 4, 5376, 262144, "rmsnorm", "none", False,
             torch.float32)]
    out += [(f"gemma3 q M={M}", M, 5376, 4096, "rmsnorm", "none", False,
             torch.bfloat16) for M in (9, 17, 1100)]
    return (out + _dense_gemm_cases() + _vit_gemm_cases()
            + _whisper_gemm_cases())


# the remaining dense decoders' widths: (tag, E, KV heads x head_dim, F,
# vocab) of chatglm3-6b, deepseek-67b and internvl2-76b
DENSE_WIDTHS = (("glm", 4096, 2 * 128, 13696, 65024),
                ("deepseek", 8192, 8 * 128, 22016, 102400),
                ("internvl2", 8192, 8 * 128, 28672, 128256))


def _dense_gemm_cases():
    """The fused GEMM at the remaining dense decoders' widths, at decode
    batch (M = 4, stream) and a 512-token prefill (wgmma): each MLP's
    down-projection (residual epilogue) and logits head (RMSNorm prologue,
    fp32 out), and deepseek-67b's q / o (E -> E) and k / v (E -> 1024)
    projections; the gated up-projections are `check_swiglu`'s."""
    out = []
    for M in (4, 512):
        for tag, E, kv, F, V in DENSE_WIDTHS:
            if tag == "deepseek":
                out += [(f"{tag} q/o M={M}", M, E, E, "rmsnorm", "none",
                         False, torch.bfloat16),
                        (f"{tag} k/v M={M}", M, E, kv, "rmsnorm", "none",
                         False, torch.bfloat16)]
            out += [(f"{tag} down M={M}", M, F, E, "none", "none", True,
                     torch.bfloat16),
                    (f"{tag} head M={M}", M, E, V, "rmsnorm", "none", False,
                     torch.float32)]
    return out


WHISPER_ROWS = 4 * 1504      # a batch-4 prefill's encoder (and memory) rows
WHISPER_BUCKET_ROWS = 4 * 192   # a batch-4 prefill's decoder rows


def _whisper_gemm_cases():
    """whisper-base's GEMMs (K 512, the MLP's down-projection K 2048): a
    batch-4 prefill's encoder q projection and MLP (LayerNorm prologue;
    i_gelu; residual) and the memory's K / V projection (no prologue: the
    memory is never normed) at M = 4 x 1504 rows, the decoder's q at a
    192-token bucket, a decode step's q, MLP and 51968-column head at M =
    4 (stream)."""
    E, F, V, bf = 512, 2048, 51968, torch.bfloat16
    out = []
    for tag, M in (("enc", WHISPER_ROWS), ("dec", 4)):
        out += [(f"whisper {tag} q M={M}", M, E, E, "layernorm", "none",
                 False, bf),
                (f"whisper {tag} up M={M}", M, E, F, "layernorm", "i_gelu",
                 False, bf),
                (f"whisper {tag} down M={M}", M, F, E, "none", "none", True,
                 bf)]
    return out + [
        (f"whisper cross k/v M={WHISPER_ROWS}", WHISPER_ROWS, E, E, "none",
         "none", False, bf),
        (f"whisper dec q M={WHISPER_BUCKET_ROWS}", WHISPER_BUCKET_ROWS, E, E,
         "layernorm", "none", False, bf),
        ("whisper head M=4", 4, E, V, "layernorm", "none", False,
         torch.float32)]


def _vit_gemm_cases():
    """The ViT pass at batch 8: the patchify GEMM (M = 8 x 196 pixels
    rows, K = 768, no prologue), each width's q projection (LN prologue),
    MLP up (LN + i_gelu) and down (residual) at M = 8 x 197; and the
    classifier head, N = 1000 (not a multiple of 16), fp32 out with its
    bias, on both templates (M = 8 streams, M = 32 runs wgmma: 31 x 8 + 8
    ragged columns in its last tile), with the final LayerNorm folded in
    (fused pass) and without (unfused)."""
    out = []
    for name, E in (("vit-b", 768), ("vit-l", 1024), ("vit-h", 1280)):
        M = 8 * 197
        if name != "vit-l":
            out.append((f"{name} patchify M=1568", 8 * 196, 768, E, "none",
                        "none", False, torch.bfloat16))
        out += [(f"{name} q M={M}", M, E, E, "layernorm", "none", False,
                 torch.bfloat16),
                (f"{name} up M={M}", M, E, 4 * E, "layernorm", "i_gelu",
                 False, torch.bfloat16),
                (f"{name} down M={M}", M, 4 * E, E, "none", "none", True,
                 torch.bfloat16)]
    for E, M, norm in ((768, 8, "layernorm"), (1280, 8, "layernorm"),
                       (1280, 8, "none"), (1280, 32, "layernorm"),
                       (1280, 32, "none")):
        tag = " LN" if norm == "layernorm" else ""
        out.append((f"head E={E} M={M} N=1000{tag} +bias", M, E, 1000, norm,
                    "none", False, torch.float32, True))
    return out


def _weights(g, dev, K, N, nb, cold, wbytes=2):
    """Weight sets for the timed calls: `cold` (decode cases) rotates as
    many copies as reach L2_ROTATE_BYTES (at `wbytes` bytes a weight), so
    that every call reads its weights from device memory, as a served
    decode step does."""
    copies = (max(1, -(-L2_ROTATE_BYTES // (K * N * wbytes * nb))) if cold
              else 1)
    return [[(torch.randn((K, N), generator=g, device=dev) * 0.02).bfloat16()
             for _ in range(nb)] for _ in range(copies)]


def _gemm_row(name, label, M, K, N, norm, act, has_res, od, has_bias=False,
              *, gated, g, int8=False):
    """One fused GEMM case: error against the plain version, with-wrapper
    and device times of the kernel and of one torch.matmul over the same
    weights (both weights side by side when gated), the bound and the
    template the planner took.  `has_bias`: an fp32-accumulated bias in
    the epilogue (the library yardstick is then torch.addmm).  `int8`: the
    weights quantized per output column (`quantize_int8_axiswise`) and
    passed as int8 with their scales; the yardstick stays one bf16
    torch.matmul over the unquantized weights (no PyTorch call computes an
    int8-weight fused GEMM), and the bound counts int8 weight bytes."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.optim.compression import quantize_int8_axiswise
    dev = torch.device(DEVICE)
    nb = 2 if gated else 1
    cold = M <= mm.STREAM_MAX_M
    ws = _weights(g, dev, K, N, nb, cold, 1 if int8 else 2)
    a = torch.randn((M, K), generator=g, device=dev).bfloat16()
    gam = (1 + 0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16()
    bet = (0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16()
    res = (torch.randn((M, N), generator=g, device=dev).bfloat16()
           if has_res else None)
    bias = ((0.1 * torch.randn((N,), generator=g, device=dev)).bfloat16()
            if has_bias else None)
    kw = dict(norm=norm, residual=res, out_dtype=od,
              eps=1e-6 if gated else 1e-5)
    if norm != "none":
        kw["gamma"] = gam
    if norm == "layernorm":
        kw["nbeta"] = bet
    # each weight as (tensor, column scale or None)
    wk = [[quantize_int8_axiswise(w, axis=(1,)) if int8 else (w, None)
           for w in ws_i] for ws_i in ws]
    if gated:
        run = lambda fn, w: fn(a, w[0][0], w[1][0], bg_scale=w[0][1],
                               bu_scale=w[1][1], **kw)
        fns = (mm.matmul_swiglu, mm.matmul_swiglu_plain)
        wl = [torch.cat(w, 1) for w in ws]
    else:
        kw.update(activation=act, bias=bias)
        run = lambda fn, w: fn(a, w[0][0], b_scale=w[0][1], **kw)
        fns = (mm.fused_matmul, mm.matmul_plain)
        wl = [w[0] for w in ws]
    kern = [lambda w=w: run(fns[0], w) for w in wk]
    plain = lambda: run(fns[1], wk[0])
    lib = [lambda w=w: torch.matmul(a, w) for w in wl]
    if has_bias:
        lib = [lambda w=w: torch.addmm(bias, a, w) for w in wl]
    wrapper = mm.matmul_swiglu if gated else mm.fused_matmul
    before = dict(wrapper.launches_by)
    got = kern[0]()
    torch.cuda.synchronize()
    template = next(k for k, n in wrapper.launches_by.items()
                    if n != before[k])
    err, rel = rel_err(got, plain())
    tol = GEMM_TOL["fp32" if od == torch.float32 else "bf16"]
    nbytes = M * K * 2 + nb * K * N * (1 if int8 else 2) + M * N * (
        4 if od == torch.float32 else 2) + (nb * N * 4 if int8 else 0)
    nbytes += (M * N * 2 if has_res else 0) + (N * 2 if has_bias else 0) + (
        {"none": 0, "rmsnorm": K * 2, "layernorm": 2 * K * 2}[norm])
    r = _row(label, err, rel, tol, time_ms(_rotate(kern)),
             time_ms(plain, iters=5), time_ms(_rotate(lib), iters=10),
             nbytes, 2 * nb * M * N * K)
    slots = {}
    if cold:           # the wrapper's plan: the card's stream occupancy
        sms, blocks = mm._stream_slots(dev, M, gated, int8)
        slots = dict(sm_count=sms, blocks_per_sm=blocks)
    plan = mm.gemm_plan(M, K, N, w_dtype=torch.int8 if int8
                        else torch.bfloat16, gated=gated, **slots)
    r.update(device_ms=device_ms(kern), library_device_ms=device_ms(lib),
             template=template, weight_copies=len(ws), splits=plan.splits)
    lib_name = "torch.addmm" if has_bias else "torch.matmul"
    _report(name, r, f"bf16 {lib_name}" if int8 else lib_name)
    del ws, wl, wk, kern, lib
    return r


def check_gemm(rows):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    rows["fused_matmul"] = [
        _gemm_row("fused_matmul", *case, gated=False, g=g)
        for case in _gemm_cases()]


def check_swiglu(rows):
    """phi4-mini's MLP up-projection, 3072 -> 2 x 8192: the fused chain
    (RMSNorm prologue) at decode batch, a 512-token prefill and ragged M (9,
    17, 1100), and the unfused chain's call (no prologue) at decode batch;
    hymba-1.5b's, 1600 -> 2 x 5504 with no prologue (its residual norm runs
    before), at decode batch and a 512-token prefill; chatglm3-6b's,
    deepseek-67b's and internvl2-76b's (`DENSE_WIDTHS`) at both.  Library
    yardstick: one torch.matmul against the two weights side by side, no
    prologue."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(4)
    cases = [("M=4 rmsnorm", 4, 3072, 8192, "rmsnorm"),
             ("M=512 rmsnorm", 512, 3072, 8192, "rmsnorm"),
             ("M=4 no norm", 4, 3072, 8192, "none")]
    cases += [(f"M={M} rmsnorm", M, 3072, 8192, "rmsnorm")
              for M in (9, 17, 1100)]
    cases += [(f"hymba M={M}", M, 1600, 5504, "none") for M in (4, 512)]
    # the remaining dense decoders' MLPs: chatglm3 4096 -> 2 x 13696,
    # deepseek 8192 -> 2 x 22016, internvl2 8192 -> 2 x 28672
    cases += [(f"{tag} M={M} rmsnorm", M, E, F, "rmsnorm")
              for M in (4, 512) for tag, E, _, F, _ in DENSE_WIDTHS]
    rows["fused_matmul_swiglu"] = [
        _gemm_row("fused_matmul_swiglu", label, M, K, N, norm, "none", False,
                  torch.bfloat16, gated=True, g=g)
        for label, M, K, N, norm in cases]


# the expert form of the gated GEMM (an MoE layer's experts, one launch):
# (label, experts, rows an expert C, K, N).  mixtral-8x7b at a decode step
# of batch 4 (C = ceil(4 x 2 / 8 x 1.25) = 2, the stream template) and at a
# 2048-token prefill (C = 640, wgmma), mixtral-8x22b's decode, and a C that
# is no multiple of any tile (37: one wgmma row tile, 91 rows of it the
# next expert's, never stored)
EXPERT_CASES = (("8x7b decode C=2", 8, 2, 4096, 14336),
                ("8x7b prefill C=640", 8, 640, 4096, 14336),
                ("8x22b decode C=2", 8, 2, 6144, 16384),
                ("8x7b C=37", 8, 37, 4096, 14336))
# the MoE router, E -> 8 experts with an fp32 output (`pdot`): N = 8 is the
# narrowest N a served GEMM runs, one 32-byte fp32 row a token, on both
# templates (decode batch 4, a 2048-token prefill)
ROUTER_CASES = (("router 8x7b M=4", 4, 4096, 8, "none", "none", False,
                 torch.float32),
                ("router 8x7b M=2048", 2048, 4096, 8, "none", "none", False,
                 torch.float32))


def check_expert_swiglu(rows):
    """The gated kernel's expert form (`EXPERT_CASES`) against its plain
    version (`expert_swiglu_plain`, fp32 products) on the same bf16
    operands, one launch a call; the library yardstick is two calls, two
    torch.bmm and silu * mul.  Then the router GEMM's cases
    (`ROUTER_CASES`) through the fused GEMM, added to its rows."""
    from repro_torch.kernels import matmul as mm
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(24)
    out = []
    for label, NE, C, K, N in EXPERT_CASES:
        xe = torch.randn((NE, C, K), generator=g, device=dev).bfloat16()
        wg, wu = ((torch.randn((NE, K, N), generator=g, device=dev) * 0.02
                   ).bfloat16() for _ in range(2))
        kern = lambda: mm.expert_swiglu(xe, wg, wu)
        plain = lambda: mm.expert_swiglu_plain(xe, wg, wu)
        lib = lambda: (torch.nn.functional.silu(torch.bmm(xe, wg))
                       * torch.bmm(xe, wu))
        before = dict(mm.expert_swiglu.launches_by)
        n0 = mm.expert_swiglu.launches
        got = kern()
        torch.cuda.synchronize()
        if mm.expert_swiglu.launches != n0 + 1:
            raise AssertionError(f"expert_swiglu {label}: "
                                 f"{mm.expert_swiglu.launches - n0} launches "
                                 f"a call, not one")
        template = next(k for k, n in mm.expert_swiglu.launches_by.items()
                        if n != before[k])
        want = plain()
        if got.shape != (NE, C, N) or not torch.isfinite(got).all():
            raise AssertionError(f"expert_swiglu {label}: shape "
                                 f"{tuple(got.shape)} or non-finite values")
        err, rel = rel_err(got, want)
        nbytes = NE * C * K * 2 + 2 * NE * K * N * 2 + NE * C * N * 2
        r = _row(label, err, rel, GEMM_TOL["bf16"], time_ms(kern),
                 time_ms(plain, iters=3), time_ms(lib, iters=10), nbytes,
                 2 * 2 * NE * C * N * K)
        slots = {}
        if C <= mm.STREAM_MAX_M:
            sms, blocks = mm._stream_slots(dev, C, True, False)
            slots = dict(sm_count=sms, blocks_per_sm=blocks)
        plan = mm.gemm_plan(C, K, N, gated=True, experts=NE, **slots)
        r.update(device_ms=device_ms([kern]), library_device_ms=device_ms(
            [lib]), template=template, splits=plan.splits,
            grid=list(plan.grid))
        _report("expert_swiglu", r, "2 x torch.bmm + silu*mul")
        out.append(r)
        del xe, wg, wu, got, want
        torch.cuda.empty_cache()
    if {r["template"] for r in out} != {"stream", "wgmma"}:
        raise AssertionError("expert_swiglu: the cases did not run both "
                             "templates")
    rows["expert_swiglu"] = out
    rows.setdefault("fused_matmul", []).extend(
        _gemm_row("fused_matmul", *case, gated=False, g=g)
        for case in ROUTER_CASES)


# the int8-weight forms (weight-only int8 serving of GPT-J and phi4-mini):
# GPT-J's projections at decode batch and a 512-token prefill (the qkv
# GEMM at M = 512 fills 64 tiles: the wgmma template splits K), its
# 50432-column fp32 head, and phi4-mini's gated up-projection
INT8_GEMM_CASES = (
    ("qkv M=4", 4, 4096, 4096, "layernorm", "none", False, torch.bfloat16),
    ("mlp_up M=4", 4, 4096, 16384, "layernorm", "i_gelu", False,
     torch.bfloat16),
    ("mlp_down M=4", 4, 16384, 4096, "none", "none", True, torch.bfloat16),
    ("head M=4", 4, 4096, 50432, "layernorm", "none", False, torch.float32),
    ("qkv M=512", 512, 4096, 4096, "layernorm", "none", False,
     torch.bfloat16),
    ("mlp_up M=512", 512, 4096, 16384, "layernorm", "i_gelu", False,
     torch.bfloat16),
    ("mlp_down M=512", 512, 16384, 4096, "none", "none", True,
     torch.bfloat16),
    ("phi4 head M=4", 4, 3072, 200192, "rmsnorm", "none", False,
     torch.float32))
INT8_SWIGLU_CASES = (("M=4 rmsnorm", 4, 3072, 8192, "rmsnorm"),
                     ("M=512 rmsnorm", 512, 3072, 8192, "rmsnorm"),
                     ("M=4 no norm", 4, 3072, 8192, "none"))


def check_gemm_int8(rows):
    """The fused GEMMs' int8-weight forms (`INT8_GEMM_CASES`,
    `INT8_SWIGLU_CASES`) against their plain versions on the same int8
    weights and scales; each row records the template and the splits the
    planner took."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(11)
    rows["fused_matmul_int8"] = [
        _gemm_row("fused_matmul int8", *case, gated=False, g=g, int8=True)
        for case in INT8_GEMM_CASES]
    rows["fused_matmul_swiglu_int8"] = [
        _gemm_row("fused_matmul_swiglu int8", label, M, K, N, norm, "none",
                  False, torch.bfloat16, gated=True, g=g, int8=True)
        for label, M, K, N, norm in INT8_SWIGLU_CASES]
    for name in ("fused_matmul_int8", "fused_matmul_swiglu_int8"):
        forms = {r["template"] for r in rows[name]}
        if forms != {"stream_int8", "wgmma_int8"}:
            raise AssertionError(f"{name}: the int8 cases ran {forms}, not "
                                 f"both int8 templates")


NORM_SHAPES = ((4, 3072), (512, 3072), (4, 2560), (512, 2560), (4, 1600),
               (512, 1600))   # phi4 / gemma3-like, mamba2, hymba widths
# LayerNorm alone: the unfused ViT pass's norms (8 x 197 rows at ViT-B /
# L / H widths; the final norm of the cls rows), GPT3-XL's encode
# pooling norm (a `last` batch's rows, a `mean` batch's 256-token bucket),
# and whisper-base's encoder final norm over a batch-4 prefill's 4 x 1504
# frames and an unfused decode step's norm
LAYERNORM_SHAPES = ((1576, 768), (1576, 1024), (1576, 1280), (8, 1280),
                    (2, 2048), (256, 2048), (4 * 1504, 512), (4, 512))
# the norm kernel's other instantiations and its looped path, checked
# against the plain version only: label, R, D, x dtype, gamma dtype,
# elements between the buffer's start and the first row
F32, BF16 = torch.float32, torch.bfloat16
NORM_PATHS = (
    ("tile fp32 x, fp32 gamma [4, 3072]", 4, 3072, F32, F32, 0),
    ("tile fp32 x, fp32 gamma [512, 1600]", 512, 1600, F32, F32, 0),
    ("tile bf16 x, fp32 gamma [512, 2560]", 512, 2560, BF16, F32, 0),
    ("tile fp32 x, bf16 gamma [4, 1600]", 4, 1600, F32, BF16, 0),
    ("looped: D % 8 != 0 [64, 1601]", 64, 1601, BF16, BF16, 0),
    ("looped: rows 2 bytes off 16 [4, 3072]", 4, 3072, BF16, BF16, 1),
    ("looped: wider than a tile [4, 20480]", 4, 20480, BF16, BF16, 0),
    ("looped fp32 x, fp32 gamma [4, 1601]", 4, 1601, F32, F32, 0),
)


def check_norms(rows):
    """RMSNorm and LayerNorm rows at phi4-mini's width (3072), mamba2's
    (2560) and hymba's (1600), at decode batch and a 512-token prefill,
    and LayerNorm at LAYERNORM_SHAPES; yardsticks F.rms_norm /
    F.layer_norm, with the wrapper, in device time and in host time a call
    (`host_ms`)."""
    from repro_torch.kernels import rmsnorm as nm
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(5)
    for name in ("rmsnorm", "layernorm"):
        results = []
        shapes = NORM_SHAPES + (LAYERNORM_SHAPES if name == "layernorm"
                                else ())
        for R, D in shapes:
            gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)
                   ).bfloat16()
            bet = (0.1 * torch.randn((D,), generator=g, device=dev)
                   ).bfloat16()
            x = (torch.randn((R, D), generator=g, device=dev) * 2 + 0.3
                 ).bfloat16()
            if name == "rmsnorm":
                fn = lambda: nm.rmsnorm(x, gam, eps=1e-6)
                plain_fn = lambda: nm.rmsnorm_plain(x, gam, eps=1e-6)
                lib_fn = lambda: F.rms_norm(x, (D,), gam, eps=1e-6)
                vec_bytes = D * 2
            else:
                fn = lambda: nm.layernorm(x, gam, bet, eps=1e-5)
                plain_fn = lambda: nm.layernorm_plain(x, gam, bet, eps=1e-5)
                lib_fn = lambda: F.layer_norm(x, (D,), gam, bet, eps=1e-5)
                vec_bytes = 2 * D * 2
            got = fn()
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_fn())
            r = _row(f"[{R}, {D}]", err, rel, NORM_TOL, time_ms(fn),
                     time_ms(plain_fn, iters=10), time_ms(lib_fn),
                     2 * R * D * 2 + vec_bytes, 4 * R * D)
            r.update(device_ms=device_ms([fn]),
                     library_device_ms=device_ms([lib_fn]), template=None,
                     host_ms=host_ms(fn), library_host_ms=host_ms(lib_fn))
            _report(name, r, "F." + ("rms_norm" if name == "rmsnorm"
                                     else "layer_norm"))
            log(f"    host, back to back: kernel {r['host_ms']:.4f} ms, "
                f"library {r['library_host_ms']:.4f} ms a call")
            results.append(r)
        rows[name] = results
    rows["norm_paths"] = check_norm_paths(g)


def _path_timing(fn, plain_fn, lib_fn, nbytes, flops):
    """Times of one NORM_PATHS / RES_NORM_PATHS case: the wrapper, the
    plain version, the library call (its weights at the input's dtype),
    device times of the kernel and the library call, and the bound."""
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(ms=time_ms(fn), plain_ms=time_ms(plain_fn, iters=5),
                library_ms=time_ms(lib_fn), device_ms=device_ms([fn]),
                library_device_ms=device_ms([lib_fn]), bound_ms=b_ms,
                bound_by=b_by)


def _log_path(name, label, rel, t, extra=""):
    log(f"  {name:9s} {label:42s} rel err {rel:.2e} (tol {NORM_TOL:.0e})"
        f"{extra} | kernel {t['ms']:.4f} ms (device {_ms(t['device_ms'])}) "
        f"plain {t['plain_ms']:.4f} ms library {t['library_ms']:.4f} ms "
        f"(device {_ms(t['library_device_ms'])}) bound {t['bound_ms']:.4f} "
        f"ms ({t['bound_by']})")


def check_norm_paths(g):
    """Each NORM_PATHS case through both norm wrappers against the plain
    version: the dtype pairs the timed rows do not take, and rows that fit
    no register tile (the looped path of the same kernel); each timed
    beside the plain version, F.rms_norm / F.layer_norm (gamma cast to x's
    dtype) and the bound (x read, the output written, gamma and beta read
    once)."""
    from repro_torch.kernels import rmsnorm as nm
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    results = []
    for label, R, D, xdt, gdt, off in NORM_PATHS:
        gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bet = (0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        buf = torch.randn((off + R * D,), generator=g, device=dev) * 2 + 0.3
        x = buf.to(xdt)[off:].view(R, D)
        gx, bx = gam.to(xdt), bet.to(xdt)
        for name, fn, plain_fn, lib_fn, nvec in (
                ("rmsnorm", lambda: nm.rmsnorm(x, gam, eps=1e-6),
                 lambda: nm.rmsnorm_plain(x, gam, eps=1e-6),
                 lambda: F.rms_norm(x, (D,), gx, eps=1e-6), 1),
                ("layernorm", lambda: nm.layernorm(x, gam, bet, eps=1e-5),
                 lambda: nm.layernorm_plain(x, gam, bet, eps=1e-5),
                 lambda: F.layer_norm(x, (D,), gx, bx, eps=1e-5), 2)):
            got = fn()
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_fn())
            t = _path_timing(fn, plain_fn, lib_fn,
                             R * D * (x.element_size() + got.element_size())
                             + nvec * D * gam.element_size(), 4 * R * D)
            _log_path(name, label, rel, t)
            if not rel <= NORM_TOL:
                raise AssertionError(f"{name} {label}: rel err {rel} > "
                                     f"{NORM_TOL}")
            results.append(dict(name=name, case=label, max_abs_err=err,
                                rel_err=rel, tol=NORM_TOL, **t))
    return results


# the residual norm kernel's other dtype pairs and its looped path, checked
# against the plain version only: label, R, D, x dtype, y dtype, gamma
# dtype, elements between the buffers' start and the first row
RES_NORM_PATHS = (
    ("tile fp32 x, fp32 y [512, 1600]", 512, 1600, F32, F32, F32, 0),
    ("tile bf16 x, bf16 y, fp32 gamma [4, 1600]", 4, 1600, BF16, BF16, F32,
     0),
    ("looped: bf16 x, fp32 y [4, 1600]", 4, 1600, BF16, F32, BF16, 0),
    ("looped: fp32 x, bf16 y [512, 1600]", 512, 1600, F32, BF16, F32, 0),
    ("looped: D % 8 != 0 [64, 1601]", 64, 1601, BF16, BF16, BF16, 0),
    ("looped: rows 2 bytes off 16 [4, 1600]", 4, 1600, BF16, BF16, BF16, 1),
    ("looped: wider than a tile [4, 20480]", 4, 20480, BF16, BF16, BF16, 0),
)


def check_residual_norms(rows):
    """The residual add + norm at hymba's width, decode batch and a
    512-token prefill: h against the plain version, r (one rounding of the
    fp32 sum) exactly; yardstick F.rms_norm(x + y) / F.layer_norm(x + y),
    with the wrapper and in device time (the add and the norm: two
    kernels).  Also the kernel's device time with its operands cold in L2
    (`cold_device_ms`: calls rotate over as many x, y and gamma copies as
    reach L2_ROTATE_BYTES), as a decode step finds x and gamma after the
    layer's weights have streamed through L2."""
    from repro_torch.kernels import rmsnorm as nm
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(6)
    D = 1600
    gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).bfloat16()
    bet = (0.1 * torch.randn((D,), generator=g, device=dev)).bfloat16()
    for name in ("residual_rmsnorm", "residual_layernorm"):
        results = []
        for R in (4, 512):
            x = (torch.randn((R, D), generator=g, device=dev) * 2 + 0.3
                 ).bfloat16()
            y = torch.randn((R, D), generator=g, device=dev).bfloat16()
            if name == "residual_rmsnorm":
                call = lambda x, y, gam, bet: nm.residual_rmsnorm(
                    x, y, gam, eps=1e-6)
                plain_fn = lambda: nm.residual_rmsnorm_plain(x, y, gam,
                                                             eps=1e-6)
                lib_fn = lambda: F.rms_norm(x + y, (D,), gam, eps=1e-6)
                vec_bytes = D * 2
            else:
                call = lambda x, y, gam, bet: nm.residual_layernorm(
                    x, y, gam, bet, eps=1e-5)
                plain_fn = lambda: nm.residual_layernorm_plain(
                    x, y, gam, bet, eps=1e-5)
                lib_fn = lambda: F.layer_norm(x + y, (D,), gam, bet,
                                              eps=1e-5)
                vec_bytes = 2 * D * 2
            fn = lambda: call(x, y, gam, bet)
            h, r = fn()
            torch.cuda.synchronize()
            ph, pr = plain_fn()
            err, rel = rel_err(h, ph)
            if not torch.equal(r, pr):
                raise AssertionError(f"{name} [{R}, {D}]: the stored "
                                     f"residual differs from x + y")
            nbytes = 4 * R * D * 2 + vec_bytes
            copies = -(-L2_ROTATE_BYTES // (2 * R * D * 2 + 2 * D * 2))
            cold = [(x.clone(), y.clone(), gam.clone(), bet.clone())
                    for _ in range(copies)]
            row = _row(f"[{R}, {D}]", err, rel, NORM_TOL, time_ms(fn),
                       time_ms(plain_fn, iters=10), time_ms(lib_fn),
                       nbytes, 6 * R * D)
            row.update(device_ms=device_ms([fn]),
                       library_device_ms=device_ms([lib_fn]), template=None,
                       cold_device_ms=device_ms(
                           [lambda o=o: call(*o) for o in cold]),
                       cold_copies=copies)
            del cold
            _report(name, row, "F." + ("rms_norm" if name.endswith("rmsnorm")
                                       else "layer_norm") + "(x + y)")
            log(f"    operands cold in L2 ({copies} copies): kernel "
                f"{_ms(row['cold_device_ms'])}")
            results.append(row)
        rows[name] = results
    rows["residual_norm_paths"] = check_residual_norm_paths(g)


def check_residual_norm_paths(g):
    """Each RES_NORM_PATHS case through both residual norm wrappers against
    the plain version: h within NORM_TOL and r bit-equal, on the dtype pairs
    the timed rows do not take and on rows that fit no register tile (the
    looped path of the same kernel); each timed beside the plain version,
    F.rms_norm / F.layer_norm of x + y (gamma cast to the sum's dtype) and
    the bound (x, y read; h, r written; gamma and beta read once)."""
    from repro_torch.kernels import rmsnorm as nm
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    results = []
    for label, R, D, xdt, ydt, gdt, off in RES_NORM_PATHS:
        gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bet = (0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bufs = [torch.randn((off + R * D,), generator=g, device=dev)
                * s + 0.3 * s for s in (2, 1)]
        x = bufs[0].to(xdt)[off:].view(R, D)
        y = bufs[1].to(ydt)[off:].view(R, D)
        sdt = torch.promote_types(xdt, ydt)
        gx, bx = gam.to(sdt), bet.to(sdt)
        for name, fn, plain_fn, lib_fn, nvec in (
                ("residual_rmsnorm",
                 lambda: nm.residual_rmsnorm(x, y, gam, eps=1e-6),
                 lambda: nm.residual_rmsnorm_plain(x, y, gam, eps=1e-6),
                 lambda: F.rms_norm(x + y, (D,), gx, eps=1e-6), 1),
                ("residual_layernorm",
                 lambda: nm.residual_layernorm(x, y, gam, bet, eps=1e-5),
                 lambda: nm.residual_layernorm_plain(x, y, gam, bet,
                                                     eps=1e-5),
                 lambda: F.layer_norm(x + y, (D,), gx, bx, eps=1e-5), 2)):
            got = fn()
            torch.cuda.synchronize()
            want = plain_fn()
            err, rel = rel_err(got[0], want[0])
            same_r = torch.equal(got[1], want[1])
            t = _path_timing(fn, plain_fn, lib_fn, R * D * (
                x.element_size() + y.element_size() + got[0].element_size()
                + got[1].element_size()) + nvec * D * gam.element_size(),
                6 * R * D)
            _log_path(name, label, rel, t,
                      f", r {'bit-equal' if same_r else 'DIFFERS'}")
            if not (rel <= NORM_TOL and same_r):
                raise AssertionError(f"{name} {label}: rel err {rel}, r "
                                     f"bit-equal {same_r}")
            results.append(dict(name=name, case=label, max_abs_err=err,
                                rel_err=rel, tol=NORM_TOL, **t))
    return results


def _ssd_inputs(g, dev, Bt, S, H, P, N, dtype=torch.bfloat16):
    """SSD operands as the block makes them: x / B / C after the conv's
    silu (bf16 on the served paths), dt = softplus(.) fp32, A = -U(1, 16),
    D = 1."""
    F = torch.nn.functional
    x = F.silu(torch.randn((Bt, S, H, P), generator=g, device=dev)
               ).to(dtype)
    dt = F.softplus(torch.randn((Bt, S, H), generator=g, device=dev) - 4)
    A = -(1 + 15 * torch.rand((H,), generator=g, device=dev))
    B, C = (F.silu(torch.randn((Bt, S, N), generator=g, device=dev)
                   ).to(dtype) for _ in range(2))
    return x, dt, A, B, C, torch.ones((H,), device=dev)


SSD_SHAPES = (("ssd_multihead", (64, 64, 16)), ("ssd", (80, 64, 128)))
# (Bt, S, x / B / C dtype): one prompt of 512 and of 137 (a prime length:
# the tail chunk is padded), the decode profile's admission group of four
# 200-token prompts, and fp32 operands (the fp32 policy's path) held to
# the fp32 tolerance in y too
SSD_CASES = ((1, 512, BF16), (1, 137, BF16), (4, 200, BF16), (1, 137, F32),
             (1, 512, F32))


def check_ssd(rows):
    """The chunked SSD scan at hymba's shape (64 padded heads x 64 x 16, the
    TPU's ssd_multihead) and mamba2's (80 heads x 64 x 128, the TPU's
    per-head ssd) in SSD_CASES.  y against the plain version at the bf16
    tolerance (fp32 operands: at the fp32 one), h_final at the fp32 one.
    No single PyTorch call computes the scan.  Bound: the bytes the function
    must move, or the sequential recurrence's 4 S H P N operations at the
    bf16 rate.  Device time: every kernel of one call (torch.profiler
    kernel events), beside the time with the wrapper; each kernel's share
    in `device_kernels`."""
    from repro_torch.kernels import ssd as sd
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(7)
    for name, (H, P, N) in SSD_SHAPES:
        results = []
        for Bt, S, dtype in SSD_CASES:
            ops_in = _ssd_inputs(g, dev, Bt, S, H, P, N, dtype)
            y, h = sd.ssd(*ops_in)
            torch.cuda.synchronize()
            py, ph = sd.ssd_plain(*ops_in)
            err, rel = rel_err(y, py)
            h_rel = rel_err(h, ph)[1]
            y_tol = SSD_TOL["y"] if dtype == BF16 else SSD_TOL["h"]
            T, eb = Bt * S, dtype.itemsize
            nbytes = (2 * T * H * P * eb + T * H * 4 + 2 * T * N * eb
                      + 2 * H * 4 + Bt * H * P * N * 4)
            fn = lambda: sd.ssd(*ops_in)
            case = (f"B={Bt} S={S} H={H} P={P} N={N}"
                    + ("" if dtype == BF16 else " fp32"))
            r = _row(case, err, rel, y_tol, time_ms(fn),
                     time_ms(lambda: sd.ssd_plain(*ops_in), iters=5), None,
                     nbytes, 4 * T * H * P * N)
            r.update(h_rel_err=h_rel, device_ms=device_ms([fn]),
                     library_device_ms=None, template=None,
                     device_kernels={k: ms for k, (ms, _) in
                                     device_kernels(fn).items()})
            log(f"  {name} {r['case']:31s} rel err y {rel:.2e} (tol "
                f"{y_tol:.0e}) h {h_rel:.2e} (tol {SSD_TOL['h']:.0e}) "
                f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                f"library none bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}) | device: kernel {_ms(r['device_ms'])} "
                + " ".join(f"[{k.split('<')[0].split('(')[0]} {v:.4f}]"
                           for k, v in r["device_kernels"].items()))
            if not (rel <= y_tol and h_rel <= SSD_TOL["h"]):
                raise AssertionError(f"{name} {r['case']}: rel err y {rel}, "
                                     f"h {h_rel}")
            results.append(r)
        rows[name] = results


FLASH_CASES = (   # label, S, H, KV, D, window, causal, q_offset[, Skv, B]
    ("gpt-j S=512 D=256", 512, 16, 16, 256, 0, True, 0),
    ("gpt3-xl S=512 D=128", 512, 16, 16, 128, 0, True, 0),
    ("phi4 S=512 H24/KV8 D=128", 512, 24, 8, 128, 0, True, 0),
    ("hymba S=512 H25/KV5 D=64", 512, 25, 5, 64, 0, True, 0),
    ("vit-b S=197 H12 D=64 bidirectional", 197, 12, 12, 64, 0, False, 0),
    ("vit-h S=197 H16 D=80 bidirectional", 197, 16, 16, 80, 0, False, 0),
    ("S=257 H16 D=80 bidirectional (ragged tile)", 257, 16, 16, 80, 0,
     False, 0),
    ("q_offset 37 S=100 H4/KV2 D=128", 100, 4, 2, 128, 0, True, 37),
    ("gemma3 S=1100 H32/KV16 D=128 window 1024", 1100, 32, 16, 128, 1024,
     True, 0),
    # chatglm3-6b (16 query heads a kv head) and deepseek-67b / internvl2-76b
    ("chatglm3 S=512 H32/KV2 D=128", 512, 32, 2, 128, 0, True, 0),
    ("deepseek S=512 H64/KV8 D=128", 512, 64, 8, 128, 0, True, 0),
    # whisper-base at batch 4: the encoder over 1504 frames, the decoder's
    # causal self-attention over a 192-token bucket, its cross-attention
    # (the bucket's queries over the 1504 memory rows, no mask: a 32-row
    # tail tile of keys), and a ragged 37-query cross call
    ("whisper enc S=1504 H8 D=64 bidirectional B=4", 1504, 8, 8, 64, 0,
     False, 0, 1504, 4),
    ("whisper dec S=192 causal H8 D=64 B=4", 192, 8, 8, 64, 0, True, 0,
     192, 4),
    ("whisper cross Sq=192 Skv=1504 H8 D=64 no mask B=4", 192, 8, 8, 64, 0,
     False, 0, 1504, 4),
    ("whisper cross Sq=37 Skv=1504 H8 D=64 no mask", 37, 8, 8, 64, 0, False,
     0, 1504, 1),
)


def check_flash(rows):
    """Prefill attention at GPT-J / GPT3-XL / phi4-mini / hymba shapes
    (causal), chatglm3-6b's (H 32 / KV 2) and deepseek-67b's (H 64 / KV
    8, D 128: internvl2-76b's too), ViT-B's and ViT-H's (D = 80)
    bidirectional encoders, also
    D = 80 at 257 tokens (a 1-row tail past four 64-row tiles), a
    causal chunk whose queries start 37 positions into the keys, and
    gemma3's local layers: window 1024 over an 1100-token prompt, and
    whisper-base's batch-4 calls (the encoder's 1504 frames, the decoder's
    causal bucket, its cross-attention: Sq != Skv with no mask).  Every
    bf16 case must plan the wgmma template.  Yardstick: SDPA, causal or
    not, or with the window or the offset as a boolean mask; device times
    of the kernel and of SDPA from torch.profiler kernel events."""
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(2)
    results = []
    for case in FLASH_CASES:
        label, S, H, KV, D, win, causal, qo = case[:8]
        Skv, B = case[8:] if len(case) > 8 else (S + qo, 1)
        q = torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, Skv, KV, D), generator=g, device=dev
                            ).bfloat16() for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=qo)
        before = dict(fa.flash_attention.launches_by)
        got = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        template = next(t for t, n in fa.flash_attention.launches_by.items()
                        if n != before[t])
        if template != "wgmma":
            raise AssertionError(f"flash_attention {label}: a bf16 case ran "
                                 f"the {template} template")
        want = fa.flash_attention_plain(q, k, v, **kw)
        err, rel = rel_err(got, want)
        fn = lambda: fa.flash_attention(q, k, v, **kw)
        ms = time_ms(fn)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                        iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if win or qo:
            i = torch.arange(S, device=dev)[:, None] + qo
            j = torch.arange(Skv, device=dev)[None, :]
            mask = j <= i
            if win:
                mask &= j > i - win
            lib_fn = lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                  enable_gqa=KV != H)
            pairs = int(mask.sum())
        else:
            lib_fn = lambda: sdpa(qt, kt, vt, is_causal=causal,
                                  enable_gqa=KV != H)
            pairs = S * (S + 1) // 2 if causal else S * Skv
        r = _row(label, err, rel, ATTN_TOL, ms, plain, time_ms(lib_fn),
                 B * 2 * (S * H + Skv * KV) * D * 2, B * 4 * H * D * pairs)
        r.update(device_ms=device_ms([fn]), library_device_ms=device_ms(
            [lib_fn]), template=template,
            # the first design (the simt template) on the same bf16
            # operands
            simt_device_ms=device_ms([lambda: fa._run("simt", q, k, v,
                                                      **kw)]))
        _report("flash_attention", r, "sdpa")
        log(f"    the first design (simt) on the same operands: device "
            f"{_ms(r['simt_device_ms'])}")
        results.append(r)
    rows["flash_attention"] = results


def _paged_inputs(g, dev, H, KV, D, lengths=(1, 137, 300, 512), BS=16,
                  dtype=torch.bfloat16):
    """Decode batch: a slot per length, BS-token blocks, 512 / BS table
    entries, absent table entries past each length and a hole inside slot
    2 when it is long enough."""
    B, MB = len(lengths), 512 // BS
    NB = B * MB + 8
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    perm = torch.randperm(NB, generator=g, device=dev)[:B * MB]
    tab = perm.reshape(B, MB).to(torch.int32)
    for b in range(B):
        tab[b, -(-int(lengths[b]) // BS):] = -1
    if int(lengths[2]) > 6 * BS:
        tab[2, 5] = -1                              # a hole inside slot 2
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((NB, BS, KV, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((NB, BS, KV, D), generator=g, device=dev).to(dtype)
    live = sum(max(0, min(BS, int(lengths[b]) - e * BS))
               for b in range(B) for e in range(MB) if int(tab[b, e]) >= 0)
    return q, kp, vp, tab, lengths, live


def _dense_from_paged(q, kp, vp, tab, lengths):
    """Dense [B, KV, S, D] copies + mask for the SDPA yardstick."""
    B, MB = tab.shape
    BS = kp.shape[1]
    safe = tab.clamp(min=0).long()
    k = kp[safe].reshape(B, MB * BS, *kp.shape[2:]).transpose(1, 2)
    v = vp[safe].reshape(B, MB * BS, *vp.shape[2:]).transpose(1, 2)
    pos = torch.arange(MB * BS, device=q.device)
    ok = (pos[None] < lengths[:, None]) & (tab >= 0).repeat_interleave(BS, 1)
    return q[:, :, None], k.contiguous(), v.contiguous(), ok[:, None, None]


GPTJ_SERVE_LENS = (200, 250, 290, 332)   # GPT-J's serving batch
GLM_PAGED = (32, 2, 128, (1, 137, 300, 512))   # H, KV, D, lengths
PAGED_CASES = (   # H, KV, D, lengths
    (16, 16, 256, (1, 137, 300, 512)),
    (24, 8, 128, (1, 137, 300, 512)),
    (16, 16, 256, GPTJ_SERVE_LENS),
    # 17 slots of 16 kv heads fill the card's SMs twice over: the
    # normalized wrapper runs one split (`paged_splits` == 1)
    (16, 16, 256, (1, 137, 300, 512, 17, 33, 64, 65, 96, 128, 160, 200,
                   250, 290, 332, 400, 480)),
    # chatglm3-6b: 16 query heads a kv head, the fold's G = 16 form
    GLM_PAGED,
    # whisper-base's decoder self-attention: 8 heads of 64
    (8, 8, 64, (1, 137, 300, 512)),
)
PAGED_SPLITS = (1, 2, 4)   # splits of the partials kernel's table


def _host_split_chain(q, kp, vp, tab, lengths, S):
    """The split-KV route the decode path ran before the split moved into
    the paged kernel's grid, rebuilt here only to count its device events:
    S masked copies of the table, q and the lengths repeated, one partials
    launch over S x B rows, then the merge rule's element-wise ops."""
    from repro_torch.kernels import flash_decode as fd
    B, MB = tab.shape
    per = -(-MB // S)
    entry = torch.arange(MB, device=tab.device)
    split = torch.arange(S, device=tab.device)
    inside = (entry[None, :] // per) == split[:, None]
    tabs = torch.where(inside[:, None, :], tab[None],
                       torch.full_like(tab[None], -1))
    o, m, l = fd.paged_decode_partials(q.repeat(S, 1, 1), kp, vp,
                                       tabs.reshape(S * B, MB),
                                       lengths.repeat(S))
    H, D = q.shape[1], q.shape[2]
    return fd.paged_decode_merge_plain(
        o.reshape(S, B, H, D), m.reshape(S, B, H), l.reshape(S, B, H),
        out_dtype=torch.float32)


def device_events(fn, iters=5):
    """Device events (kernels and copies) of one call, from a
    torch.profiler trace of `iters` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / iters


def check_paged(rows):
    """The paged decode kernel at GPT-J's, phi4-mini's and chatglm3-6b's
    (H 32 / KV 2: the fold's G = 16 form) widths over a
    mixed batch (lengths 1..512, a hole in the table), over GPT-J's
    serving batch (lengths 200-332) and over 17 slots: the partials kernel
    at 1, 2 and 4 splits of the table (each split's statistics and the
    merged output held row by row to the plain split grid, and the merge
    to the single plain pass), the merge kernel, and the normalized
    wrapper (partials, then the merge), which splits the table as
    `paged_splits` says for this card (held to the same plain split and to
    the single pass); the 17-slot case must run it at one split.  Yardstick: SDPA over dense copies
    with a boolean mask; device times of both from torch.profiler kernel
    events.  Bound: the bytes of q, the live K / V rows and the outputs.
    On GPT-J's serving batch the decode path's one paged route (the
    normalized wrapper) is counted in device events against the host-side
    split chain it replaced."""
    from repro_torch.kernels import flash_decode as fd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows["paged_decode_partials"], rows["paged_decode_attention"] = [], []
    merge = lambda o, m, l: fd.paged_decode_merge_plain(
        o, m, l, out_dtype=torch.float32)
    for H, KV, D, lens in PAGED_CASES:
        case = (f"B={len(lens)} H={H}/KV={KV} D={D} BS=16 len "
                + "/".join(str(n) for n in lens))
        q, kp, vp, tab, lengths, live = _paged_inputs(g, dev, H, KV, D,
                                                      lens)
        B = q.shape[0]
        dq, dk, dv, mask = _dense_from_paged(q, kp, vp, tab, lengths)
        lib_fn = lambda: sdpa(dq, dk, dv, attn_mask=mask, enable_gqa=KV != H)
        lib = time_ms(lib_fn)
        lib_dev = device_ms([lib_fn])
        flops = 4 * H * D * live
        nbytes = q.numel() * 2 + 2 * live * KV * D * 2
        po, pm, pl = fd.paged_decode_plain(q, kp, vp, tab, lengths)
        one = po / pl.clamp(min=1e-30)[..., None]       # the single pass
        plain = time_ms(lambda: fd.paged_decode_plain(q, kp, vp, tab,
                                                      lengths), iters=5)
        s_att = fd.paged_splits(B, KV, tab.shape[1], sms=sms,
                                at_least=fd.paged_min_splits(tab.shape[1],
                                                             16))
        runs = [("paged_decode_attention", s_att,
                 lambda: fd.paged_decode_attention(q, kp, vp, tab, lengths),
                 B * H * D * 2)]
        runs += [("paged_decode_partials", S,
                  lambda S=S: fd.paged_decode_partials(q, kp, vp, tab,
                                                       lengths, S),
                  S * B * H * (D + 2) * 4) for S in PAGED_SPLITS]
        for name, S, fn, out_bytes in runs:
            got = fn()
            torch.cuda.synchronize()
            so, sm, sl = fd.paged_decode_plain(q, kp, vp, tab, lengths, S)
            want = merge(so, sm, sl) if S > 1 else so / sl[..., None]
            extra = ""
            if name == "paged_decode_attention":
                err, rel, per = row_rel_err(got, want.bfloat16())
                rel = max(rel, row_rel_err(got, one.bfloat16())[1])
            else:
                o, m, l = got
                merged = merge(o, m, l) if S > 1 else o / l[..., None]
                err, rel, per = row_rel_err(merged, want)
                rel = max(rel, row_rel_err(merged, one)[1])
                # each split's statistics, not only the merged ratio
                live_rows = sl > 0
                if not torch.equal(l > 0, live_rows):
                    raise AssertionError(f"{name} {case} splits {S}: live "
                                         f"ranges differ from the plain grid")
                for a, b in ((m, sm), (l, sl)):
                    rel = max(rel, rel_err(a[live_rows], b[live_rows])[1])
                if S > 1:
                    # the merge kernel against the plain merge of the same
                    # partials and against the single pass
                    mfn = lambda: fd.paged_decode_merge(
                        o, m, l, out_dtype=torch.bfloat16)
                    mk = mfn()
                    torch.cuda.synchronize()
                    rel = max(rel, row_rel_err(mk, fd.paged_decode_merge_plain(
                        o, m, l, out_dtype=torch.bfloat16))[1],
                        row_rel_err(mk, one.bfloat16())[1])
                    extra = f"; merge kernel device {_ms(device_ms([mfn]))}"
            label = case if name == "paged_decode_attention" or S == 1 \
                else f"{case} splits {S}"
            r = _row(label, err, rel, ATTN_TOL, time_ms(fn), plain, lib,
                     nbytes + out_bytes, flops)
            r.update(row_rel_err=per, device_ms=device_ms([fn]),
                     library_device_ms=lib_dev, template=f"splits {S}")
            _report(name, r, "sdpa")
            if extra:
                log(f"    {label}{extra}")
            rows[name].append(r)
        if lens == GPTJ_SERVE_LENS:
            new = device_events(lambda: fd.paged_decode_attention(
                q, kp, vp, tab, lengths))
            old_fn = lambda: _host_split_chain(q, kp, vp, tab, lengths, 2)
            rel = row_rel_err(old_fn(), one)[1]
            old = device_events(old_fn)
            rows["paged_split_route_events"] = {
                "kernel_split": new, "host_chain": old,
                "host_chain_rel_err": rel}
            log(f"  decode path's paged route on {case}: {new:.0f} "
                f"device events a call (the host split chain it replaced: "
                f"{old:.0f}, its result within {rel:.2e} of the single pass)")
    if not any(r["template"] == "splits 1"
               for r in rows["paged_decode_attention"]):
        raise AssertionError("paged_decode_attention: no case ran at one "
                             "split of the table")
    rows["paged_block_sizes"] = check_paged_block_sizes(g)


# the int8-pool form at GPT-J's serving batch and at phi4-mini's GQA
PAGED_INT8_CASES = ((16, 16, 256, GPTJ_SERVE_LENS),
                    (24, 8, 128, (1, 137, 300, 512)), GLM_PAGED)


def check_paged_int8(rows):
    """The paged decode's int8-pool form (`PAGED_INT8_CASES`): pools
    quantized per (block, kv head) as the cache scatters write them, the
    partials kernel at 1, 2 and 4 splits of the table (merged, and each
    split's m / l) and the normalized wrapper, each held row by row to the
    plain int8 fold at the same split (chatglm3-6b's heads included: the
    G = 16 form over int8 pools).  Yardstick: bf16 SDPA over dense
    copies of the unquantized pools (no PyTorch call reads an int8 pool
    with scales).  Bound: q, the live int8 K / V rows, their blocks'
    scales and the outputs."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.optim.compression import quantize_int8_axiswise
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(13)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows["paged_decode_partials_int8"] = []
    rows["paged_decode_attention_int8"] = []
    merge = lambda o, m, l: fd.paged_decode_merge_plain(
        o, m, l, out_dtype=torch.float32)
    for H, KV, D, lens in PAGED_INT8_CASES:
        case = (f"B={len(lens)} H={H}/KV={KV} D={D} BS=16 len "
                + "/".join(str(n) for n in lens))
        q, kp, vp, tab, lengths, live = _paged_inputs(g, dev, H, KV, D, lens)
        kq, ks = quantize_int8_axiswise(kp, axis=(0, 2))
        vq, vs = quantize_int8_axiswise(vp, axis=(0, 2))
        sc = dict(k_scale=ks, v_scale=vs)
        B = q.shape[0]
        dq, dk, dv, mask = _dense_from_paged(q, kp, vp, tab, lengths)
        lib_fn = lambda: sdpa(dq, dk, dv, attn_mask=mask, enable_gqa=KV != H)
        lib, lib_dev = time_ms(lib_fn), device_ms([lib_fn])
        entry = torch.arange(tab.shape[1], device=dev)
        blocks = int(((tab >= 0) & (entry[None] * 16 < lengths[:, None]))
                     .sum())
        nbytes = q.numel() * 2 + 2 * live * KV * D + 2 * blocks * KV * 4
        flops = 4 * H * D * live
        plain = time_ms(lambda: fd.paged_decode_plain(q, kq, vq, tab, lengths,
                                                      **sc), iters=5)
        s_att = fd.paged_splits(B, KV, tab.shape[1], sms=sms,
                                at_least=fd.paged_min_splits(tab.shape[1],
                                                             16))
        runs = [("paged_decode_attention_int8", s_att,
                 lambda: fd.paged_decode_attention(q, kq, vq, tab, lengths,
                                                   **sc), B * H * D * 2)]
        runs += [("paged_decode_partials_int8", S,
                  lambda S=S: fd.paged_decode_partials(q, kq, vq, tab,
                                                       lengths, S, **sc),
                  S * B * H * (D + 2) * 4) for S in PAGED_SPLITS]
        for name, S, fn, out_bytes in runs:
            before = dict(getattr(fd, name[:-5]).launches_by)
            got = fn()
            torch.cuda.synchronize()
            if getattr(fd, name[:-5]).launches_by["int8"] != \
                    before["int8"] + 1:
                raise AssertionError(f"{name}: no int8-pool launch")
            so, sm, sl = fd.paged_decode_plain(q, kq, vq, tab, lengths, S,
                                               **sc)
            want = merge(so, sm, sl) if S > 1 else so / sl[..., None]
            if name == "paged_decode_attention_int8":
                err, rel, per = row_rel_err(got, want.bfloat16())
            else:
                o, m, l = got
                merged = merge(o, m, l) if S > 1 else o / l[..., None]
                err, rel, per = row_rel_err(merged, want)
                live_rows = sl > 0
                if not torch.equal(l > 0, live_rows):
                    raise AssertionError(f"{name} {case} splits {S}: live "
                                         f"ranges differ from the plain grid")
                for a, b in ((m, sm), (l, sl)):
                    rel = max(rel, rel_err(a[live_rows], b[live_rows])[1])
            label = case if name == "paged_decode_attention_int8" or S == 1 \
                else f"{case} splits {S}"
            r = _row(label, err, rel, ATTN_TOL, time_ms(fn), plain, lib,
                     nbytes + out_bytes, flops)
            r.update(row_rel_err=per, device_ms=device_ms([fn]),
                     library_device_ms=lib_dev, template=f"splits {S}")
            _report(name, r, "bf16 sdpa")
            rows[name].append(r)


# the paged fold's other instantiations, checked against the plain version
# only: block sizes the kernel reads at run time, and fp32 pools
PAGED_FOLDS = ((8, torch.bfloat16), (32, torch.float32), (16, torch.float32))


def check_paged_block_sizes(g):
    """The partials kernel at 1 and 2 splits and the normalized wrapper at
    each PAGED_FOLDS block size and dtype (phi4-mini's heads, the mixed
    batch): split statistics and merged output held row by row to the
    plain split grid and to the single pass; each call timed beside the
    plain version (the single pass), SDPA over dense copies at the pools'
    dtype, and the bound (q, the live K / V rows, the outputs)."""
    from repro_torch.kernels import flash_decode as fd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    results = []
    for BS, dtype in PAGED_FOLDS:
        q, kp, vp, tab, lengths, live = _paged_inputs(g, dev, 24, 8, 128,
                                                      BS=BS, dtype=dtype)
        po, _, pl = fd.paged_decode_plain(q, kp, vp, tab, lengths)
        one = po / pl.clamp(min=1e-30)[..., None]
        B, H, D = q.shape
        dq, dk, dv, mask = _dense_from_paged(q, kp, vp, tab, lengths)
        lib_fn = lambda: sdpa(dq, dk, dv, attn_mask=mask, enable_gqa=True)
        common = dict(
            plain_ms=time_ms(lambda: fd.paged_decode_plain(
                q, kp, vp, tab, lengths), iters=5),
            library_ms=time_ms(lib_fn), library_device_ms=device_ms([lib_fn]))
        esize = q.element_size()
        in_bytes = q.numel() * esize + 2 * live * kp.shape[2] * D * esize

        def timing(fn, out_bytes):
            b_ms, b_by = bound_ms(in_bytes + out_bytes, 4 * H * D * live)
            return dict(common, ms=time_ms(fn), device_ms=device_ms([fn]),
                        bound_ms=b_ms, bound_by=b_by)
        for S in (1, 2):
            o, m, l = fd.paged_decode_partials(q, kp, vp, tab, lengths, S)
            so, sm, sl = fd.paged_decode_plain(q, kp, vp, tab, lengths, S)
            if S == 1:
                o, m, l, so, sm, sl = (t[None] for t in (o, m, l, so, sm, sl))
            live_rows = sl > 0
            if not torch.equal(l > 0, live_rows):
                raise AssertionError(f"paged_decode_partials BS={BS} "
                                     f"{dtype} splits {S}: live ranges "
                                     f"differ from the plain grid")
            merged = fd.paged_decode_merge_plain(o, m, l,
                                                 out_dtype=torch.float32)
            rel = max(row_rel_err(merged, fd.paged_decode_merge_plain(
                so, sm, sl, out_dtype=torch.float32))[1],
                row_rel_err(merged, one)[1],
                rel_err(m[live_rows], sm[live_rows])[1],
                rel_err(l[live_rows], sl[live_rows])[1])
            results.append(dict(
                name="paged_decode_partials", bs=BS, dtype=str(dtype),
                splits=S, rel_err=rel, **timing(
                    lambda S=S: fd.paged_decode_partials(q, kp, vp, tab,
                                                         lengths, S),
                    S * B * H * (D + 2) * 4)))
        fn = lambda: fd.paged_decode_attention(q, kp, vp, tab, lengths)
        got = fn()
        results.append(dict(name="paged_decode_attention", bs=BS,
                            dtype=str(dtype), rel_err=row_rel_err(
                                got, one.to(dtype))[1],
                            **timing(fn, B * H * D * esize)))
    for r in results:
        label = (f"{r['name']} BS={r['bs']} {r['dtype']}"
                 + (f" splits {r['splits']}" if "splits" in r else ""))
        log(f"  {label:50s} rel err {r['rel_err']:.2e} (tol {ATTN_TOL:.0e})"
            f" | kernel {r['ms']:.4f} ms (device {_ms(r['device_ms'])}) "
            f"plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
            f"(device {_ms(r['library_device_ms'])}) bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        if not r["rel_err"] <= ATTN_TOL:
            raise AssertionError(f"{label}: rel err {r['rel_err']} > "
                                 f"{ATTN_TOL}")
    return results


DECODE_CASES = (   # label, H, KV, D, S, lengths, window, dtype
    ("gemma3 ring B=4 H32/KV16 D=128 S=1024 len 1/137/1000/1024", 32, 16,
     128, 1024, (1, 137, 1000, 1024), 0, torch.bfloat16),
    ("hymba ring B=4 H25/KV5 D=64 S=1024 len 1/137/1000/1024", 25, 5, 64,
     1024, (1, 137, 1000, 1024), 0, torch.bfloat16),
    ("linear B=4 H32/KV16 D=128 S=2048 window 1024 len 1/700/1500/2048",
     32, 16, 128, 2048, (1, 700, 1500, 2048), 1024, torch.bfloat16),
    # the fp32 instantiation (the served paths' fp32 policy)
    ("fp32 linear B=4 H32/KV16 D=128 S=2048 window 1024 len 1/700/1500/2048",
     32, 16, 128, 2048, (1, 700, 1500, 2048), 1024, torch.float32),
    # a speculative draft's step: linear caches of max_seq 512 rows, no
    # window, at the widths of GPT-J's and phi4-mini's drafts
    ("draft linear B=4 H16/KV16 D=256 S=512 len 1/137/300/512", 16, 16,
     256, 512, (1, 137, 300, 512), 0, torch.bfloat16),
    ("draft linear B=4 H24/KV8 D=128 S=512 len 1/137/300/512", 24, 8,
     128, 512, (1, 137, 300, 512), 0, torch.bfloat16),
    # whisper-base's cross step: every row attends the memory's 1504 rows
    ("whisper cross B=4 H8/KV8 D=64 S=1504 len 1504", 8, 8, 64, 1504,
     (1504,) * 4, 0, torch.bfloat16),
    # chatglm3-6b-draft: 16 query heads a kv head, the fold's G = 16 form
    ("draft linear B=4 H32/KV2 D=128 S=512 len 1/137/300/512", 32, 2,
     128, 512, (1, 137, 300, 512), 0, torch.bfloat16),
)


def check_decode_attention(rows):
    """The dense decode kernel on gemma3's and hymba's ring caches (the
    valid slots are a prefix of the ring), on a linear cache with gemma3's
    window (in bf16, and in fp32) and on the speculative drafts' linear
    512-row caches (no window, GPT-J's, phi4-mini's and chatglm3-6b's
    widths: the last the fold's G = 16 form), each
    batch row held to its own scale against the
    plain version at the kernel's split count (`splits=`: the same ranges,
    32-position stages and merge) and against the TPU kernel's walk (one
    pass of 512-position chunks).  Yardstick: SDPA with a boolean mask.
    Bound: the bytes of q, the valid K / V rows and the output."""
    from repro_torch.kernels import flash_decode as fd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    for label, H, KV, D, S, lens, win, dtype in DECODE_CASES:
        B = len(lens)
        q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((B, S, KV, D), generator=g, device=dev
                            ).to(dtype) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        splits = fd.dense_splits(B, KV, S, sms, window=win)
        got = fd.decode_attention(q, k, v, ln, window=win)
        torch.cuda.synchronize()
        err, rel, per = row_rel_err(got, fd.decode_attention_plain(
            q, k, v, ln, window=win, splits=splits))
        one = row_rel_err(got, fd.decode_attention_plain(q, k, v, ln,
                                                         window=win))
        rel = max(rel, one[1])
        per = [max(a, b) for a, b in zip(per, one[2])]
        pos = torch.arange(S, device=dev)[None]
        ok = pos < ln[:, None].long()
        if win:
            ok &= pos >= ln[:, None].long() - win
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        lib_fn = lambda: sdpa(q[:, :, None], kt, vt,
                              attn_mask=ok[:, None, None],
                              enable_gqa=KV != H)
        live = int(ok.sum())
        fn = lambda: fd.decode_attention(q, k, v, ln, window=win)
        r = _row(label, err, rel, ATTN_TOL, time_ms(fn),
                 time_ms(lambda: fd.decode_attention_plain(
                     q, k, v, ln, window=win, splits=splits), iters=5),
                 time_ms(lib_fn),
                 (2 * B * H * D + 2 * live * KV * D) * q.element_size()
                 + B * 4, 4 * H * D * live)
        r.update(splits=splits, range=fd.dense_range(S, splits),
                 device_ms=device_ms([fn]),
                 library_device_ms=device_ms([lib_fn]),
                 template=f"splits {splits}", row_rel_err=per)
        log("  decode_attention rel err by row (len " + ", ".join(
            f"{n}: {e:.2e}" for n, e in zip(lens, per)) + ")")
        _report("decode_attention", r, "sdpa")
        results.append(r)
    rows["decode_attention"] = results


# --------------------------------------------------------------------------
# 4. sampling: threefry noise on the card vs the CPU
# --------------------------------------------------------------------------

def phase_sampling():
    """The sampler's Gumbel noise at phi4-mini's padded vocabulary for a
    few (seed, step) pairs, drawn on the card and on the CPU: random bits,
    uniforms and noise must be bit-equal, and the tokens `_lane_scores`
    picks from one set of logits identical."""
    from repro_torch.configs import PHI4_MINI
    from repro_torch.core import embedding as emb
    from repro_torch.core import prng
    from repro_torch.serving.sampling import device_lane
    Vp = PHI4_MINI.padded_vocab
    seeds = np.array([0, 100, 106, 2**31 - 1, 77, 5], np.int64)
    steps = np.array([0, 301, 45, 511, 2**31 - 1, 9], np.int64)
    tiny = torch.finfo(torch.float32).tiny
    draws = {}
    for dev in ("cpu", DEVICE):
        k = prng.fold_in(prng.fold_in(
            prng.key(torch.tensor(seeds, device=dev)),
            torch.tensor(steps, device=dev)), 0)
        draws[dev] = [t.cpu() for t in (
            prng.random_bits(k, Vp), prng.uniform(k, Vp, minval=tiny),
            prng.gumbel(k, Vp))]
    (cb, cu, cg), (db, du, dg) = draws["cpu"], draws[DEVICE]
    bits_equal = torch.equal(cb, db)
    unif_equal = torch.equal(cu.view(torch.int32), du.view(torch.int32))
    g_equal = torch.equal(cg.view(torch.int32), dg.view(torch.int32))

    rng = np.random.default_rng(9)
    B = len(seeds)
    z = torch.tensor(rng.standard_normal((B, Vp)).astype(np.float32) * 3)
    z[:, PHI4_MINI.vocab:] = -1e30
    lane = {"temperature": np.array([0.8, 0.8, 1.0, 0.5, 1.3, 0.0],
                                    np.float32),
            "top_k": np.array([40, 0, 40, 64, 1, 0], np.int32),
            "seed": seeds, "step": steps}
    tok_cpu = emb._lane_scores(z, device_lane(lane, "cpu")).argmax(-1)
    tok_dev = emb._lane_scores(z.to(DEVICE), device_lane(
        lane, DEVICE)).argmax(-1).cpu()
    sampled = device_lane({"temperature": np.full(2, 0.8, np.float32),
                           "top_k": np.full(2, 40, np.int32),
                           "seed": seeds[:2], "step": steps[:2]}, DEVICE)
    noise_ms = time_ms(lambda: emb.gumbel_noise(sampled, Vp), iters=10)
    log(f"sampling: {B} (seed, step) pairs over {Vp} columns, card vs CPU: "
        f"bits equal {bits_equal}, uniforms bit-equal {unif_equal}, Gumbel "
        f"noise bit-equal {g_equal}, tokens {tok_dev.tolist()} vs "
        f"{tok_cpu.tolist()}; noise for 2 sampled rows {noise_ms:.4f} ms")
    if not (bits_equal and unif_equal and g_equal
            and torch.equal(tok_cpu, tok_dev)):
        raise AssertionError("threefry sampling differs between the card "
                             "and the CPU")
    return {"bits_equal": bits_equal, "uniforms_bit_equal": unif_equal,
            "gumbel_bit_equal": g_equal,
            "tokens": tok_dev.tolist(), "noise_ms_2_rows": noise_ms}


# --------------------------------------------------------------------------
# 5. serve end to end
# --------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import ops
    return ops.launch_counters()


TOTAL_LAUNCHES = {}            # kernel -> launches over every driven path
TOTAL_BY = {}                  # kernel -> form -> launches over every path
GEMM_WRAPPERS = ("fused_matmul", "fused_matmul_swiglu", "expert_swiglu")
PAGED_WRAPPERS = ("paged_decode_attention", "paged_decode_partials")
# wrappers with launches_by: the GEMMs by template and weight form, flash
# by template, the paged decode by pool dtype
TEMPLATED = GEMM_WRAPPERS + ("flash_attention",) + PAGED_WRAPPERS
GEMM_KERNELS = ("stream_kernel", "splitk_finish", "wgmma_kernel",
                "fused_mm_kernel", "fused_swiglu_kernel")
TEMPLATE_LAUNCHES = {}         # path -> wrapper -> template -> launches
PATH_LAUNCHES = {}             # path -> kernel -> launches


def drive(path, fn, need):
    """Run one path with every launch counter zeroed just before and read
    just after; fail if a kernel in `need` never launched, if a GEMM ran
    the fp32-weight template (every driven path serves bf16 weights), or if
    a flash launch ran another template than wgmma (every driven path
    prefills in bf16)."""
    counters = _counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    for k in TEMPLATED:
        counters[k].launches_by = dict.fromkeys(counters[k].launches_by, 0)
    out = fn()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    PATH_LAUNCHES[path] = launches
    for k, n in launches.items():
        TOTAL_LAUNCHES[k] = TOTAL_LAUNCHES.get(k, 0) + n
    by = {k: dict(counters[k].launches_by) for k in TEMPLATED}
    TEMPLATE_LAUNCHES[path] = by
    for k, forms in by.items():
        for t, n in forms.items():
            TOTAL_BY.setdefault(k, {}).setdefault(t, 0)
            TOTAL_BY[k][t] += n
    missing = [k for k in need if launches[k] == 0]
    log(f"  [{path}] launches {launches}")
    log(f"  [{path}] launches by template {by}")
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    fma32 = {k: by[k]["fma32"] for k in GEMM_WRAPPERS if by[k]["fma32"]}
    if fma32:
        raise AssertionError(f"{path}: a bf16 / int8 path launched the fma32 "
                             f"template: {fma32}")
    flash = by["flash_attention"]
    if flash["wgmma"] != launches["flash_attention"]:
        raise AssertionError(f"{path}: a bf16 prefill flash launch ran "
                             f"another template than wgmma: {flash}")
    return out, launches


def moe_layers(cfg):
    from repro_torch.configs.base import MOE_KINDS
    return sum(c for k, c in cfg.schedule if k in MOE_KINDS)


def gemms_per_pass(cfg, *, decode=False):
    """(fused GEMMs, gated GEMMs) the layers of `cfg` launch in one pass of
    the fused chain: q / k / v / o per attention layer, the five SSM
    projections (x, z, B|C, dt, out: `pdot`, the hand GEMM with no
    prologue) per SSM layer, per MLP the down-projection plus the
    up-projection (gated for SwiGLU), and per MoE layer the router
    (`pdot`) alone: its experts run the gated kernel's expert form
    (`expert_forms`) and their down-projection a cuBLAS bmm; pure SSM
    layers have no MLP.  An encoder-decoder's `dec` layer adds its
    cross-attention's q / k / v / o in a full pass and q / o alone in a
    decode step (`decode`: the memory's K / V are cached), and a full
    pass runs the encoder's layers too (`enc`: the `attn` block)."""
    from repro_torch.configs.base import ATTN_KINDS, MOE_KINDS
    fused = gated = 0
    sched = cfg.schedule + (() if decode else cfg.enc_schedule)
    for kind, count in sched:
        if kind == "dec":
            fused += (2 if decode else 4) * count
        if kind in ATTN_KINDS:
            fused += 4 * count
        if kind in ("ssm", "hybrid_attn", "hybrid_local"):
            fused += 5 * count
        if kind in MOE_KINDS:
            fused += count
        elif kind != "ssm":
            swiglu = cfg.mlp_act == "swiglu"
            fused += (1 if swiglu else 2) * count
            gated += (1 if swiglu else 0) * count
    return fused, gated


def track_prefill_rows(eng):
    """A list that collects the rows (bucket x group) of every prefill
    pass the engine's runner runs from now on: an MoE layer's dispatch,
    and so the expert form's template, depends on them.  The wrapper holds
    the runner weakly: a cycle through it would keep the engine and its
    weights alive until the next garbage collection."""
    import weakref
    rows = []
    runner = weakref.ref(eng.runner)
    step_for = type(eng.runner)._prefill_for

    def tracked(bucket, group, stats):
        rows.append(bucket * group)
        return step_for(runner(), bucket, group, stats)
    eng.runner._prefill_for = tracked
    return rows


def expert_forms(cfg, *, prefill_rows=(), rows_decode=()):
    """{form: launches} of the expert form over a run: per MoE layer, each
    prefill pass of T rows dispatches `mlp._chunks(T)` chunks (capacity
    ceil(Tc K / NE x 1.25) each), and each pass of the decode path (a
    decode step, a chunk or a verify pass) of R rows one chunk (capacity
    max(1, ceil(R K / NE x 1.25))): one launch each, on the template
    `gemm_plan` takes for that capacity."""
    import math
    from repro_torch.core import mlp
    from repro_torch.kernels.matmul import FORMS, gemm_plan
    forms = dict.fromkeys(FORMS, 0)
    n = moe_layers(cfg)
    if not n:
        return forms
    caps = []
    for T in prefill_rows:
        nc = mlp._chunks(T)
        caps += [int(math.ceil(T // nc * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor))] * nc
    caps += [max(1, int(math.ceil(R * cfg.top_k / cfg.n_experts
                                  * cfg.capacity_factor)))
             for R in rows_decode]
    for c in caps:
        t = gemm_plan(c, cfg.d_model, cfg.d_ff, gated=True,
                      experts=cfg.n_experts).template
        forms[t] += n
    return forms


def chunk_passes(eng):
    """{width: passes run} of an engine's chunk steps (one step a width;
    `launch/steps.py:make_chunk_prefill_step` counts its calls)."""
    return {w: s.aux["calls"] for w, s in eng.runner._chunk_steps.items()}


def check_gemm_templates(cfg, st, by, *, int8=False, chunks=None,
                         prefill_rows=None, batch=4):
    """Prefill GEMMs run the wgmma template and decode GEMMs the stream
    template: each GEMM of the layers (`gemms_per_pass`, the plain `pdot`
    products included) launches wgmma once a prefill pass and stream once
    a decode step; the logits head (M = the pass's sequences, <= 4)
    streams in both.  An encode batch runs the layers' GEMMs once at M =
    its tasks x its bucket rows, which the served encodes keep above 8
    (wgmma), and no head.  A chunk pass of width C (`chunks`: {C: passes},
    summing to the stats' prefill_chunks) runs the layers' GEMMs at M = C
    (wgmma above 8 rows, stream at 8) and its head on one row (stream).
    `int8`: every one of them runs the template's int8-weight form, and no
    bf16 form launches at all (no int8 weight is widened to a bf16
    copy).  An MoE config's expert form launches as `expert_forms` says
    for the prefill passes' rows (`prefill_rows`, one entry a pass), the
    decode steps' `batch` rows and the chunk passes' widths."""
    P, D, E = st.prefill_batches, st.decode_steps, st.encode_batches
    chunks = chunks or {}
    if sum(chunks.values()) != st.prefill_chunks:
        raise AssertionError(f"{cfg.name}: chunk passes {chunks} != "
                             f"{st.prefill_chunks} in the stats")
    Cw = sum(n for w, n in chunks.items() if w > 8)     # wgmma chunk passes
    Cs = sum(n for w, n in chunks.items() if w <= 8)    # stream chunk passes
    mm, sw = by["fused_matmul"], by["fused_matmul_swiglu"]
    per_layer, per_swiglu = gemms_per_pass(cfg)
    per_step = gemms_per_pass(cfg, decode=True)[0]
    sfx = "_int8" if int8 else ""
    want = {"fused_matmul": {"stream" + sfx: (P + Cw + (D + Cs)
                                              * (per_step + 1)),
                             "wgmma" + sfx: (P + E + Cw) * per_layer},
            "fused_matmul_swiglu": {"stream" + sfx: (D + Cs) * per_swiglu,
                                    "wgmma" + sfx: (P + E + Cw)
                                    * per_swiglu}}
    if moe_layers(cfg) and (prefill_rows is None
                            or len(prefill_rows) != P):
        raise AssertionError(f"{cfg.name}: {P} prefill passes but rows of "
                             f"{prefill_rows}")
    want["expert_swiglu"] = expert_forms(
        cfg, prefill_rows=prefill_rows or (),
        rows_decode=[batch] * D + [w for w, n in chunks.items()
                                   for _ in range(n)])
    for forms in want.values():
        for t in ("fma32", "stream", "wgmma", "stream_int8", "wgmma_int8"):
            forms.setdefault(t, 0)
    got = {k: by[k] for k in GEMM_WRAPPERS}
    log(f"  [{cfg.name} serve] GEMM templates: {per_layer} fused GEMMs and "
        f"{per_swiglu} gated GEMMs of the layers per pass, {P} prefill, "
        f"{E} encode and {sum(chunks.values())} chunk passes (by width "
        f"{dict(sorted(chunks.items()))}); launches {got}, expected {want} "
        f"(observed "
        f"{mm['wgmma' + sfx] / max(P + E, 1):.1f} and "
        f"{sw['wgmma' + sfx] / max(P + E, 1):.1f} wgmma a pass)")
    if got != want:
        raise AssertionError(f"{cfg.name} serve: GEMM templates {got} != "
                             f"{want}")


def _head(params, cfg, x, *, fused, policy):
    """Logits [B, vocab] fp32 of final hidden states x [B, E] through the
    final norm (fused as a prologue or not) and the unembedding."""
    from repro_torch.core.embedding import logits_local
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    norm = lm._head_norm(params, cfg, fused)
    if norm is None:
        x = ops.norm(x, params["final_norm"], cfg.norm)
    return logits_local(x, params["embedding"]["unemb"], cfg=cfg,
                        policy=policy, norm=norm)[:, :cfg.vocab].float()


def teacher_forced(cfg, params, prompt, *, mode, fused, policy=None,
                   max_seq=512, patches=None, frames=None):
    """Final-position logits [1, vocab] fp32 of one prompt through the
    prefill stack and the logits head, fused or unfused chain, under a
    kernel mode and a precision policy (default bf16); a VLM config's
    prompt behind its `patches`; an encoder-decoder's encoder over its
    `frames` first, the decoder's layers over its output."""
    from repro_torch.core.precision import BF16
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    policy = policy or BF16
    with ops.kernel_mode(mode), torch.no_grad():
        memory = lm._memory(params, frames, cfg=cfg, policy=policy,
                            fused=fused)
        x = lm._embed_sequence(params, prompt, cfg=cfg, policy=policy,
                               patches=patches)
        x, _ = lm._run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                        max_seq=max_seq, fused=fused,
                                        compact_kv=True, memory=memory)
        return _head(params, cfg, x[:, -1], fused=fused, policy=policy)


def _gap(got, want):
    """(max|dz| / max|z|, angle in radians) between two logit rows."""
    cos = torch.nn.functional.cosine_similarity(got, want).item()
    return rel_err(got, want)[1], float(np.arccos(min(1.0, cos)))


def _logit_gate(label, got, want, floor, k, *, minimum=True, quiet=False):
    """Hold `got` to `want`: max|dz| / max|z| <= max(LOGIT_TOL, k * floor)
    and the angle between them <= max(acos(LOGIT_COS), k * floor angle),
    where `floor` is the gap between the plain bf16 path and the plain fp32
    path — what bf16 rounding alone moves these logits by.  With
    `minimum=False` the gate is k * floor alone."""
    rel, ang = _gap(got, want)
    tol, ang_max = k * floor[0], k * floor[1]
    if minimum:
        tol, ang_max = max(LOGIT_TOL, tol), max(np.arccos(LOGIT_COS), ang_max)
    cos_min = float(np.cos(ang_max))
    cos = float(np.cos(ang))
    finite = bool(torch.isfinite(got).all())
    if not quiet or not (finite and rel <= tol and cos >= cos_min):
        log(f"  teacher-forced {label}: rel {rel:.2e} (tol {tol:.2e}), "
            f"cosine {cos:.6f} (min {cos_min:.6f}), argmax "
            f"{int(got.argmax())} vs {int(want.argmax())}")
    if not (finite and rel <= tol and cos >= cos_min):
        raise AssertionError(f"teacher-forced logits disagree: {label}")
    return {"rel": rel, "cosine": cos, "tol": tol, "cos_min": cos_min}


def cross_layers(cfg):
    """Decoder layers with cross-attention over an encoder's memory."""
    return sum(c for k, c in cfg.schedule if k == "dec")


def norm_launches(cfg, fused):
    """(a prefill pass, a decode step, an encode pass) launches of the
    plain norm kernel of a LayerNorm config of `attn` / `dec` layers (and
    an encoder of `enc` layers): fused, the encoder's final norm a full
    pass and the pooling norm an encode pass, every other norm folded into
    a GEMM; unfused, each block's norms (two, a `dec` block three) and the
    final norm (the full-sequence one before a prefill's head, the head's
    in a decode step, the pooling norm of an encode pass), and the
    encoder's final norm a full pass."""
    enc = 1 if cfg.enc_schedule else 0
    if fused:
        return enc, 0, enc + 1
    per = lambda sched: sum((3 if k == "dec" else 2) * c for k, c in sched)
    dec = per(cfg.schedule) + 1
    full = dec + per(cfg.enc_schedule) + enc
    return full, dec, full


def ring_layers(cfg, max_seq):
    """Layers whose window is shorter than max_seq: dense ring caches."""
    from repro_torch.configs.base import ATTN_KINDS
    from repro_torch.core import blocks
    return sum(c for k, c in cfg.schedule
               if k in ATTN_KINDS and not blocks.kind_paged(k, cfg, max_seq))


def path_kernels(cfg, path, *, max_seq=512, encode=False):
    """The kernels a path of `cfg` must launch: `serve` (engine prefill and
    the captured decode step, fused: every paged layer through the one
    paged route, whose C entry runs the partials kernel and the merge;
    `encode`: EncodeTasks too, whose pooling norm runs the plain norm
    kernel), `fused` / `unfused` (one teacher-forced prefill)."""
    from repro_torch.configs.base import ATTN_KINDS
    kinds = {k for k, _ in cfg.schedule}
    attention = bool(kinds & set(ATTN_KINDS))
    hybrid = bool(kinds & {"hybrid_attn", "hybrid_local"})
    need = set()
    if path != "unfused":
        need.add("fused_matmul")                 # the fused logits head
    if attention:
        need.add("flash_attention")
    if attention and path == "serve":
        need.add("paged_decode_attention")
        if ring_layers(cfg, max_seq) or cross_layers(cfg):
            need.add("decode_attention")    # rings, and the cross step
    if cfg.mlp_act == "swiglu" and kinds - {"ssm", "moe", "moe_local"}:
        need.add("fused_matmul_swiglu")
    if kinds & {"moe", "moe_local"} and path != "unfused":
        # the experts (unfused: two bmm and the silu-mul) and the MoE ln2
        need |= {"expert_swiglu", "residual_rmsnorm"}
    if cfg.has_ssm:
        need |= {"ssd", "rmsnorm"}               # SSM and hybrid ln1
    if hybrid and path != "unfused":
        need.add("residual_rmsnorm")             # the hybrid ln2
    if path == "unfused" or encode or cfg.enc_schedule:
        need.add(cfg.norm)                  # an encoder's final norm too
    return tuple(sorted(need))


def check_serve_counts(cfg, launches, st, max_seq, by=None, kv_int8=False,
                       fused=True):
    """The dense decode kernel runs once per ring layer per decode step and
    never in prefill, the paged route once per paged layer per decode step
    (its own wrappers for the partials and the merge never), every one of
    those launches in the int8-pool form when `kv_int8` and in the bf16
    form otherwise (`by`: the path's launches by form); flash once per
    attention layer per prefill or encode pass; the SSD kernel once per
    SSM layer per prefill pass, the residual RMSNorm once per hybrid layer
    per prefill pass and decode step, and once per MoE layer per prefill
    pass, chunk pass and decode step (the fused ln2); in a LayerNorm config
    the plain
    LayerNorm only as an encode batch's pooling norm, once a batch (the
    fused engine folds every other norm into a GEMM); the chunk partials
    (device torch ops, no hand kernel) once per attention layer per chunk
    pass, and never without one.  An encoder-decoder adds, a full
    (prefill or encode) pass, one flash launch per encoder layer and one
    per `dec` layer (its cross-attention: the text over the memory's
    rows), and a decode step one dense decode per `dec` layer (the cross
    step over the cached memory); its encoder's final norm runs the plain
    LayerNorm once a full pass (`norm_launches`, which also counts an
    unfused engine's norms)."""
    from repro_torch.configs.base import ATTN_KINDS
    attn_layers = sum(c for k, c in cfg.schedule if k in ATTN_KINDS)
    enc_layers = sum(c for k, c in cfg.enc_schedule if k in ATTN_KINDS)
    rings, cross = ring_layers(cfg, max_seq), cross_layers(cfg)
    want = {"decode_attention": (rings + cross) * st.decode_steps,
            "paged_decode_attention": (attn_layers - rings) * st.decode_steps,
            "paged_decode_partials": 0, "paged_decode_merge": 0,
            "flash_attention": (attn_layers + cross + enc_layers) * (
                st.prefill_batches + st.encode_batches),
            "paged_chunk_partials": attn_layers * st.prefill_chunks}
    if cfg.norm == "layernorm":
        pre, dec, enc = norm_launches(cfg, fused)
        want["layernorm"] = (pre * st.prefill_batches + dec * st.decode_steps
                             + enc * st.encode_batches)
    if cfg.has_ssm:
        ssm_layers = sum(c for k, c in cfg.schedule
                         if k in ("ssm", "hybrid_attn", "hybrid_local"))
        hybrid_layers = sum(c for k, c in cfg.schedule
                            if k in ("hybrid_attn", "hybrid_local"))
        want.update(ssd=ssm_layers * st.prefill_batches,
                    residual_rmsnorm=hybrid_layers * (st.prefill_batches
                                                      + st.decode_steps))
    if moe_layers(cfg):
        want["residual_rmsnorm"] = moe_layers(cfg) * (
            st.prefill_batches + st.decode_steps + st.prefill_chunks)
    got = {k: launches[k] for k in want}
    if by is not None:
        paged = want["paged_decode_attention"]
        want["paged_decode_attention by form"] = {
            "bf16": 0 if kv_int8 else paged, "fp32": 0,
            "int8": paged if kv_int8 else 0}
        got["paged_decode_attention by form"] = by["paged_decode_attention"]
    log(f"  [{cfg.name} serve] {st.prefill_batches} prefill passes, "
        f"{st.encode_batches} encode passes, {st.prefill_chunks} chunk "
        f"passes, {st.decode_steps} decode steps: launches {got}, expected "
        f"{want}")
    if got != want:
        raise AssertionError(f"{cfg.name} serve: launches {got} != {want}")


def graph_pool_gb():
    """GB the caching allocator holds in private pools: the captured
    graphs' pools (the step's activations and kernel scratch, kept between
    replays as free blocks, so `memory_allocated` does not count them)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 1e9


def _clone_caches(caches):
    return tuple({k: v.clone() for k, v in seg.items()} for seg in caches)


def check_graph_vs_eager(eng, cfg):
    """The runner's captured decode step, replayed, against an eager
    `lm.forward_decode` on clones of the same caches at the same inputs
    (the runner's slots as they stand: seated, mid-decode): next tokens
    and pos + 1 identical, every cache leaf bit-equal.  The runner's
    caches are restored afterwards, so the engine goes on as if neither
    step had run."""
    from repro_torch.models import lm
    from repro_torch.serving.sampling import device_lane
    r = eng.runner
    step = r.decode_step.fn
    if step.graph is None:
        raise AssertionError(f"{cfg.name}: the decode step is not captured")
    dev = torch.device(DEVICE)
    saved, eager = _clone_caches(r.caches), _clone_caches(r.caches)
    with torch.no_grad():
        tok_g, pos_g, _ = step(r.tokens, r.pos, r.block_tables, r.lane)
        tok_g, pos_g = tok_g.clone(), pos_g.clone()
        tok_e, _ = lm.forward_decode(
            r.params, torch.tensor(r.tokens, device=dev),
            torch.tensor(r.pos, device=dev), eager, cfg=cfg, policy=r.policy,
            block_tables=torch.tensor(r.block_tables, device=dev),
            lane=device_lane(r.lane, dev), fused=r.fuse_epilogues,
            paged_segments=r.layout.segments)
    torch.cuda.synchronize()
    diffs = {}
    for i, (seg_g, seg_e) in enumerate(zip(r.caches, eager)):
        for k in seg_g:
            if not torch.equal(seg_g[k], seg_e[k]):
                diffs[f"segment {i} {k}"] = float(
                    (seg_g[k].float() - seg_e[k].float()).abs().max())
    same_tok = torch.equal(tok_g, tok_e.to(torch.int32))
    same_pos = torch.equal(pos_g.cpu(), torch.from_numpy(r.pos + 1))
    for seg, seg_s in zip(r.caches, saved):
        for k in seg:
            seg[k].copy_(seg_s[k])
    del saved, eager
    leaves = sum(len(seg) for seg in r.caches)
    log(f"  [{cfg.name}] captured decode step vs eager forward_decode "
        f"({len(r.decoding_slots())} live slots, pos {r.pos.tolist()}): "
        f"tokens {tok_g.tolist()} vs {tok_e.tolist()}, pos + 1 equal "
        f"{same_pos}, {leaves - len(diffs)} of {leaves} cache leaves "
        f"bit-equal{f', differing: {diffs}' if diffs else ''}")
    if not (same_tok and same_pos and not diffs):
        raise AssertionError(f"{cfg.name}: the graph replay differs from "
                             f"the eager decode step")
    return {"tokens_equal": same_tok, "pos_equal": same_pos,
            "cache_leaves": leaves, "leaves_bit_equal": leaves - len(diffs)}


def _gemm_key(name):
    """The wrapper a GEMM kernel of a profile belongs to: its GATED and EX
    template arguments (stream_kernel<MT, GATED, I8, EX>,
    wgmma_kernel<GATED, I8, EX>, splitk_finish<GATED, EX>) or the fp32
    template's own kernels."""
    if "fused_swiglu_kernel" in name:
        return "fused_matmul_swiglu"
    m = re.search(r"(stream_kernel|wgmma_kernel|splitk_finish)<([^>]*)>",
                  name)
    if m is None:
        return "fused_matmul"
    args = [a.strip() for a in m.group(2).split(",")]
    if args[-1] == "true":
        return "expert_swiglu"
    gated = args[1 if m.group(1) == "stream_kernel" else 0] == "true"
    return "fused_matmul_swiglu" if gated else "fused_matmul"


def profile_decode(eng, cfg, rng, steps=4, prompt_len=200,
                   graph_check=False):
    """Where a decode step's time goes: a full batch (4 slots,
    `prompt_len`-token prompts, one row sampled) runs `steps` decode steps
    timed on the host clock, then `steps` more under torch.profiler; the
    paged layers split their tables as the shapes say at either length.
    `graph_check`: after admission, `check_graph_vs_eager`.  Reports the
    device's busy time per step (kernel time, from the profile) against
    the unprofiled step, the largest kernels, the host launch calls a step
    (cudaGraphLaunch, cudaLaunchKernel) and the host ops that cost the
    most CPU time (the profiler's own cost inflates these)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Request, SamplingParams
    for uid in range(4):
        sp = (SamplingParams(temperature=0.8, top_k=40, seed=uid) if uid == 0
              else SamplingParams())
        eng.submit(Request(uid=1000 + prompt_len + uid, prompt=rng.integers(
            0, cfg.vocab, prompt_len, dtype=np.int32),
            max_new_tokens=2 * steps + 2,
            sampling=sp))
    eng.step()                      # admission prefill + one decode step
    torch.cuda.synchronize()
    graph = check_graph_vs_eager(eng, cfg) if graph_check else None
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    if eng.allocator.num_free != eng.allocator.num_blocks:
        raise AssertionError("KV blocks leaked")
    dev, host = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            dev[ev.key] = (us / 1e3 / steps, ev.count // steps)
        else:
            host[ev.key] = (ev.self_cpu_time_total / 1e3 / steps,
                            ev.count // steps)
    # host launch calls a step: one cudaGraphLaunch for the captured
    # step, the eager path's cudaLaunchKernel calls before it
    calls = {k: host.get(k, (0.0, 0))[1]
             for k in ("cudaGraphLaunch", "cudaLaunchKernel",
                       "cudaLaunchKernelExC", "cuLaunchKernel")}
    out = {"steps": steps, "prompt_len": prompt_len, "step_ms": step_ms,
           "host_launch_calls": calls}
    if graph is not None:
        out["graph_vs_eager"] = graph
    log(f"  [{cfg.name} decode profile, {prompt_len}-token prompts] host "
        f"launch calls a step: {calls}")
    if not dev:
        log(f"  [{cfg.name} decode profile, {prompt_len}-token prompts] "
            f"{step_ms:.2f} ms/step; the profiler saw no kernels: device "
            f"time not measured")
        return out
    busy = sum(ms for ms, _ in dev.values())
    # the GEMM templates' kernels (gemm.cuh; GATED = the SwiGLU kernel)
    gemm = {k: [0.0, 0] for k in GEMM_WRAPPERS}
    for name, (ms, n) in dev.items():
        if any(k in name for k in GEMM_KERNELS):
            key = _gemm_key(name)
            gemm[key][0] += ms
            gemm[key][1] += n
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]

    def _share(pred):
        hits = [v for k, v in dev.items() if pred(k)]
        return (sum(ms for ms, _ in hits), sum(n for _, n in hits))

    # the decode kernels and their merges, the norm kernels; library GEMMs
    # (cuBLAS / CUTLASS: none of the port's projections should reach one
    # but an MoE layer's expert down-projection, the reference's own
    # dot_general, a torch.bmm); copies and casts
    shares = {
        "paged_decode": _share(lambda k: "paged_decode_kernel" in k),
        "decode_attention": _share(lambda k: "decode_attention_kernel" in k),
        # the merge kernel of both decode kernels (decode_fold.cuh)
        "decode_merge": _share(lambda k: "dec_merge_kernel" in k),
        "norm": _share(lambda k: re.search(r"(?<!res_)norm_kernel", k)
                       is not None),
        "residual_norm": _share(lambda k: "res_norm_kernel" in k),
        "library_gemm": _share(lambda k: re.search(
            r"gemm|gemv|xmma|cutlass|nvjet", k, re.I) is not None and not any(
                g in k for g in GEMM_KERNELS)),
        "copy": _share(lambda k: "copy" in k.lower()),
    }
    log(f"  [{cfg.name} decode profile, {prompt_len}-token prompts] "
        f"{step_ms:.2f} ms/step unprofiled, "
        f"device busy {busy:.2f} ms/step ({busy / step_ms:.1%}); "
        f"{sum(n for _, n in dev.values())} device events per step")
    for key, (ms, n) in gemm.items():
        log(f"    {key} (every template) {ms:.3f} ms/step in {n} kernel "
            f"launches")
    for key, (ms, n) in shares.items():
        log(f"    {key} {ms:.3f} ms/step in {n} kernel launches")
    for name, (ms, n) in top:
        log(f"    device {ms:8.3f} ms/step  x{n:<5d} {name[:80]}")
    for name, (ms, n) in top_host:
        log(f"    host   {ms:8.3f} ms/step  x{n:<5d} {name[:80]}")
    out.update(device_busy_ms=busy, busy_share=busy / step_ms,
               device_events=sum(n for _, n in dev.values()),
               gemm_ms_per_step={k: v[0] for k, v in gemm.items()},
               per_step={k: {"ms": ms, "launches": n}
                         for k, (ms, n) in shares.items()},
               device_top=[{"kernel": k, "ms_per_step": ms, "per_step": n}
                           for k, (ms, n) in top],
               host_top=[{"op": k, "cpu_ms_per_step": ms, "per_step": n}
                         for k, (ms, n) in top_host])
    return out


def profile_prefill(cfg, params, rng, *, prompt_len=512, max_seq=512):
    """Where a prefill pass's time goes: one `prompt_len`-token prompt
    through the fused prefill stack and the logits head (`teacher_forced`,
    `auto` mode; an encoder-decoder's encoder over zero frames first, as
    served), once to warm up, once timed on the host clock, then once
    under torch.profiler (`device_kernels`).  Reports the device's busy
    time (kernel time) against the pass, the device events, the SSD
    kernels' share (every kernel of `csrc/ssd.cu`), the GEMM templates'
    share and the largest kernels; for an encoder-decoder also the
    encoder's share of the pass (its own pass profiled alone, against the
    whole pass's busy time)."""
    from repro_torch.core.precision import BF16
    from repro_torch.models import frontends, lm
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, prompt_len),
                                       dtype=np.int32), device=DEVICE)
    frames = frontends.serving_frames(cfg, 1, device=DEVICE)
    run = lambda: teacher_forced(cfg, params, prompt, mode="auto",
                                 fused=True, max_seq=max_seq, frames=frames)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    pass_ms = (time.perf_counter() - t0) * 1e3
    dev = device_kernels(run, iters=1)
    out = {"prompt_len": prompt_len, "pass_ms": pass_ms}
    if not dev:
        log(f"  [{cfg.name} prefill profile, {prompt_len} tokens] "
            f"{pass_ms:.2f} ms; the profiler saw no kernels: device time "
            f"not measured")
        return out
    busy = sum(ms for ms, _ in dev.values())

    def _share(pred):
        hits = [v for k, v in dev.items() if pred(k)]
        return (sum(ms for ms, _ in hits), sum(n for _, n in hits))

    shares = {"ssd": _share(lambda k: k.startswith("void ssd_")
                            or k.startswith("ssd_")),
              "gemm": _share(lambda k: any(g in k for g in GEMM_KERNELS)),
              "flash": _share(lambda k: "flash" in k)}
    events = sum(n for _, n in dev.values())
    log(f"  [{cfg.name} prefill profile, {prompt_len} tokens] {pass_ms:.2f} "
        f"ms unprofiled, device busy {busy:.3f} ms ({busy / pass_ms:.1%}); "
        f"{events} device events")
    for key, (ms, n) in shares.items():
        log(f"    {key} {ms:.3f} ms ({ms / busy:.1%} of busy) in {n} kernel "
            f"launches")
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, n) in top:
        log(f"    device {ms:8.3f} ms  x{n:<5d} {name[:80]}")
    out.update(device_busy_ms=busy, busy_share=busy / pass_ms,
               device_events=events,
               shares={k: {"ms": ms, "launches": n, "share_of_busy": ms / busy}
                       for k, (ms, n) in shares.items()},
               device_top=[{"kernel": k, "ms": ms, "launches": n}
                           for k, (ms, n) in top])
    if cfg.enc_schedule:
        with torch.no_grad():
            enc = device_kernels(lambda: lm._run_encoder(
                params, frames, cfg=cfg, policy=BF16), iters=1)
        enc_ms = sum(ms for ms, _ in enc.values())
        log(f"    the encoder alone: device busy {enc_ms:.3f} ms "
            f"({enc_ms / busy:.1%} of the pass's), "
            f"{sum(n for _, n in enc.values())} device events")
        out.update(encoder_busy_ms=enc_ms, encoder_share=enc_ms / busy)
    return out


SERVE_LENGTHS = (300, 40, 120, 60, 20, 90, 200, 150)
# (pooling, prompt length) of the EncodeTasks interleaved with GPT3-XL's
# generate requests: the two `last` tasks share bucket 128 and one batch
# (M = 256); the `mean` ones run alone in buckets 64 and 256 — every
# batch above the stream template's 8 rows
SERVE_ENCODES = (("last", 100), ("mean", 60), ("last", 120), ("mean", 250))


def check_encodes(cfg, params, tasks, max_seq):
    """Each EncodeTask's embedding (fused kernel path, padded to its
    bucket) held to a direct exact-length `forward_encode` on the plain
    (`ref`) path in bf16 (k = 2) and fp32 (k = 1.5) under the serve phase's
    floor-scaled gate, the floor being the gap between those two."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.kernels import ops
    from repro_torch.models import frontends, lm
    out = {}
    # an encoder-decoder's encodes were served behind zero frames
    frames = frontends.serving_frames(cfg, 1, device=DEVICE)
    for t in tasks:
        tok = torch.tensor(np.asarray(t.prompt)[None], device=DEVICE)
        with ops.kernel_mode("ref"), torch.no_grad():
            z_ref, z_fp32 = (lm.forward_encode(params, tok, cfg=cfg,
                                               policy=pol, pooling=t.pooling,
                                               frames=frames)
                             for pol in (BF16, FP32))
        z = torch.tensor(t.embedding, device=DEVICE)[None]
        if z.shape != z_ref.shape:
            raise AssertionError(f"encode {t.uid}: embedding shape "
                                 f"{tuple(z.shape)}")
        floor = _gap(z_ref, z_fp32)
        label = (f"{cfg.name} encode {t.uid} ({t.pooling}, {t.prompt_len} "
                 f"tokens in bucket {t.bucket})")
        log(f"  {label}: plain bf16 vs plain fp32 (floor) rel "
            f"{floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
        out[t.uid] = {
            "pooling": t.pooling, "prompt_len": t.prompt_len,
            "bucket": t.bucket, "encode_ms": t.encode_ms,
            "latency_ms": t.latency_ms,
            "floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))},
            "vs_plain_bf16": _logit_gate(f"{label} vs plain bf16", z, z_ref,
                                         floor, 2.0),
            "vs_plain_fp32": _logit_gate(f"{label} vs plain fp32", z,
                                         z_fp32, floor, 1.5)}
    return out


def check_patch_prefix(eng, done):
    """A VLM engine's patch prefix (zero patch rows ahead of every served
    prompt): the prompt cap is max_seq - 1 - n_patches and a longer prompt
    is refused naming the prefix; each served request's blocks count the
    prefix; the chunk policy, the prefix cache and speculation are refused
    with the reference's reasons, which are printed."""
    from repro_torch.serving import Request
    from repro_torch.serving.spec import spec_support_reason
    r, cfg = eng.runner, eng.runner.cfg
    n_p = cfg.n_patches
    cap = r.max_seq - 1 - n_p
    if r.prompt_cap != cap or r._n_prefix != n_p:
        raise AssertionError(f"{cfg.name}: prompt cap {r.prompt_cap}, "
                             f"prefix {r._n_prefix}; want {cap}, {n_p}")
    try:
        eng.submit(Request(uid=-1, prompt=np.zeros(cap + 1, np.int32),
                           max_new_tokens=1))
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"{cfg.name}: a {cap + 1}-token prompt was "
                             f"admitted")
    if f"patch prefix={n_p}" not in refusal:
        raise AssertionError(f"{cfg.name}: refusal {refusal!r}")
    bs = r.layout.block_size
    blocks = {q.uid: r.blocks_needed(q) for q in done}
    want = {q.uid: -(-(n_p + q.prompt_len + len(q.output)) // bs)
            for q in done}
    if blocks != want:
        raise AssertionError(f"{cfg.name}: blocks {blocks} != {want}")
    chunk, spec = r.chunk_unsupported_reason, spec_support_reason(cfg)
    if (chunk != "patch prefixes occupy unpaged cache positions" or spec
            != "VLM patch prefixes are not supported in verify chunks"):
        raise AssertionError(f"{cfg.name}: refusals {chunk!r}, {spec!r}")
    log(f"  [{cfg.name}] patch prefix {n_p}: prompt cap {cap} (a "
        f"{cap + 1}-token prompt refused: {refusal}); blocks with the "
        f"prefix {sorted(blocks.values())}; chunked prefill and the prefix "
        f"cache refused: {chunk}; speculation refused: {spec}")
    return {"prompt_cap": cap, "refusal": refusal, "blocks": blocks,
            "chunk_refusal": chunk, "spec_refusal": spec}


def serve_model(cfg, *, seed, max_seq=512, lengths=SERVE_LENGTHS,
                prefill_profile=False, encodes=(), weight_dtype="bfloat16",
                kv_dtype=None, params=None, teacher=True, fused=True):
    """Serve len(lengths) requests of 32 new tokens (uids 1 and 6 sampled)
    through InferenceEngine at full width, the EncodeTasks `encodes`
    ((pooling, length) pairs, uids 100 + i) interleaved with the first of
    them, then profile decode steps (and, `prefill_profile`, one prefill
    pass of max_seq tokens) and teacher-force one prompt through the fused
    kernel path, the unfused kernel path and the plain path.  The engine
    captures its decode step once, at construction; every decode step of
    the run must be a replay of that one graph, and the first profile
    holds a replay to the eager step (`check_graph_vs_eager`).
    A VLM config serves its prompts behind zero patch rows
    (`check_patch_prefix`), and teacher-forces its prompt behind seeded
    ones.  An encoder-decoder serves its prompts behind zero frames, and
    teacher-forces its prompt behind seeded ones (so that the gates see
    the encoder).  `weight_dtype` / `kv_dtype`: the engine's int8 knobs;
    with int8 weights the teacher-forced paths run on the engine's
    quantized weights, and every GEMM launch must be an int8 form (with
    int8 KV, every paged launch).  `params`: the caller's bf16 weights
    (else drawn from `seed`); `teacher=False` leaves out the
    teacher-forced gates (the MoE phase runs them on its own witness);
    `fused=False`: the engine runs the unfused chain (discrete norms)."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.models import lm
    from repro_torch.serving import (EncodeTask, InferenceEngine, Request,
                                     SamplingParams)

    t0 = time.perf_counter()
    if params is None:
        params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE,
                            seed=seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    ssm = (f" SSM {cfg.ssm_heads}->{cfg.padded_ssm_heads()} heads x "
           f"{cfg.ssm_head_dim} state {cfg.ssm_state}" if cfg.has_ssm else "")
    enc = (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq_padded} "
           f"frames" if cfg.enc_schedule else "")
    log(f"serve: {cfg.name} {cfg.n_layers} layers{enc} d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff}{ssm} "
        f"{cfg.mlp_act} {cfg.norm} vocab {cfg.vocab}->{cfg.padded_vocab}: "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=max_seq,
                          block_size=16, policy=BF16, device=DEVICE,
                          weight_dtype=weight_dtype, kv_dtype=kv_dtype,
                          fuse_epilogues=fused)
    torch.cuda.synchronize()
    step = eng.runner.decode_step
    tag = (f"{cfg.name} int8" if weight_dtype == "int8" or kv_dtype == "int8"
           else cfg.name) + ("" if fused else " unfused")
    build_s = time.perf_counter() - t0
    cache_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(eng.runner.caches)) / 1e9
    graph_gb = graph_pool_gb()
    peak_build = torch.cuda.max_memory_allocated() / 1e9
    log(f"  [{cfg.name}] engine built in {build_s:.2f} s, decode step "
        f"captured {step.aux['captured']}; caches {cache_gb:.3f} GB, the "
        f"graph's memory pool {graph_gb:.3f} GB, peak allocated "
        f"{peak_build:.2f} GB")
    if not step.aux["captured"]:
        raise AssertionError(f"{cfg.name}: the decode step is not captured")
    prefill_rows = track_prefill_rows(eng)
    rng = np.random.default_rng(0)
    enc_tasks = []
    for uid, n in enumerate(lengths):
        sp = (SamplingParams(temperature=0.8, top_k=40, seed=100 + uid)
              if uid in (1, 6) else SamplingParams())
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, n, dtype=np.int32), max_new_tokens=32, sampling=sp))
        if uid < len(encodes):
            pooling, m = encodes[uid]
            enc_tasks.append(EncodeTask(uid=100 + uid, prompt=rng.integers(
                0, cfg.vocab, m, dtype=np.int32), pooling=pooling))
            eng.submit(enc_tasks[-1])
    t0 = time.perf_counter()
    replays = step.fn.replays
    done, launches = drive(f"{tag} serve", eng.run,
                           path_kernels(cfg, "serve", max_seq=max_seq,
                                        encode=bool(encodes)))
    wall = time.perf_counter() - t0
    st = eng.stats()
    replays = step.fn.replays - replays
    log(f"  [{cfg.name} serve] {st.decode_steps} decode steps, "
        f"{replays} replays of the one captured graph")
    if eng.runner.decode_step is not step or replays != st.decode_steps:
        raise AssertionError(f"{cfg.name}: {st.decode_steps} decode steps "
                             f"but {replays} replays of its graph")
    check_serve_counts(cfg, launches, st, max_seq,
                       by=TEMPLATE_LAUNCHES[f"{tag} serve"],
                       kv_int8=st.kv_dtype == "int8", fused=fused)
    check_gemm_templates(cfg, st, TEMPLATE_LAUNCHES[f"{tag} serve"],
                         int8=weight_dtype == "int8",
                         prefill_rows=list(prefill_rows))
    if (st.weight_dtype, st.kv_dtype) != (weight_dtype, kv_dtype
                                          or "bfloat16"):
        raise AssertionError(f"{tag}: the stats report {st.weight_dtype} / "
                             f"{st.kv_dtype}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    enc_log = ""
    if encodes:
        enc_log = (f" | encode {st.encode_tok_s:.1f} tok/s ({st.encode_batches}"
                   f" batches) latency p50 {st.encode_latency_p50_ms:.1f} ms")
    log(f"serve: {len(done)} requests in {wall:.2f} s | NAR "
        f"{st.nar_tok_s:.1f} tok/s | AR {st.ar_tok_s:.1f} tok/s | TTFT p50 "
        f"{st.ttft_p50_ms:.1f} ms | decode step p50 "
        f"{st.decode_step_p50_ms:.2f} ms p95 {st.decode_step_p95_ms:.2f} ms |"
        f" peak memory {peak_gb:.2f} GB | weights {st.weight_dtype} "
        f"{st.weight_bytes_per_device / 1e9:.3f} GB, KV {st.kv_dtype} "
        f"{st.kv_pool_bytes / 1e9:.3f} GB{enc_log}")
    if len(done) != len(lengths) + len(encodes):
        raise AssertionError(f"{len(done)} of {len(lengths) + len(encodes)} "
                             f"finished")
    if any(not (t.done and t.embedding is not None) for t in enc_tasks):
        raise AssertionError("an EncodeTask has no embedding")
    done = [r for r in done if not isinstance(r, EncodeTask)]
    for r in done:
        if len(r.output) != 32:
            raise AssertionError(f"request {r.uid}: {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of vocab")
    if eng.allocator.num_free != eng.allocator.num_blocks:
        raise AssertionError("KV blocks leaked")
    prefix = check_patch_prefix(eng, done) if cfg.n_patches else None
    report = {"launches": {"serve": launches},
              "gemm_templates": TEMPLATE_LAUNCHES[f"{tag} serve"],
              "stats": st.to_dict(),
              "wall_s": wall, "peak_memory_gb": peak_gb, "params": n_params,
              "engine_build_s": build_s, "caches_gb": cache_gb,
              "graph_pool_gb": graph_gb,
              "graph_replays": replays,
              "max_seq": max_seq, "layers": cfg.n_layers,
              "teacher_forced": {}, "decode_profile": profile_decode(
                  eng, cfg, rng, graph_check=True),
              "decode_profile_split": profile_decode(eng, cfg, rng,
                                                     prompt_len=300)}
    if prefix is not None:
        report["patch_prefix"] = prefix
    served = eng.runner.params       # the engine's weights (int8: quantized)
    del eng
    torch.cuda.empty_cache()
    if encodes:
        report["encode"] = check_encodes(cfg, params, enc_tasks, max_seq)
    if prefill_profile:
        report["prefill_profile"] = profile_prefill(
            cfg, params, np.random.default_rng(1), prompt_len=max_seq,
            max_seq=max_seq)

    if not teacher:
        del params, served
        torch.cuda.empty_cache()
        return report
    # teacher-forced: one prompt through the two kernel paths, held to the
    # plain bf16 path (`ref` mode) and the plain fp32 path; the gap between
    # those two is the rounding floor the gates scale with
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 96),
                                       dtype=np.int32), device=DEVICE)
    # a VLM's prompt behind seeded patch rows, an encoder-decoder's behind
    # seeded frames (the serve trace's are zero)
    pk = {"max_seq": max_seq}
    if cfg.n_patches or cfg.enc_schedule:
        from repro_torch.models import frontends
        batch = frontends.make_batch(cfg, 1, (cfg.n_patches or 0) + 96,
                                     seed=seed, device=DEVICE)
        pk.update({k: batch[k] for k in ("patches", "frames") if k in batch})
    z_ref = teacher_forced(cfg, served, prompt, mode="ref", fused=True, **pk)
    z_fp32 = teacher_forced(cfg, served, prompt, mode="ref", fused=True,
                            policy=FP32, **pk)
    floor = _gap(z_ref, z_fp32)
    log(f"  teacher-forced {tag} plain bf16 vs plain fp32 (floor): rel "
        f"{floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
    tf = report["teacher_forced"]
    tf["floor"] = {"rel": floor[0], "cosine": float(np.cos(floor[1]))}
    for path, fused in (("fused", True), ("unfused", False)):
        z, report["launches"][f"teacher_forced_{path}"] = drive(
            f"{tag} teacher-forced {path}",
            lambda: teacher_forced(cfg, served, prompt, mode="auto",
                                   fused=fused, **pk),
            path_kernels(cfg, path))
        # two paths each within the floor of fp32 lie within twice the
        # floor of each other
        tf[f"{path}_vs_plain_bf16"] = _logit_gate(
            f"{tag} {path} kernel path vs plain bf16", z, z_ref, floor,
            2.0)
        tf[f"{path}_vs_plain_fp32"] = _logit_gate(
            f"{tag} {path} kernel path vs plain fp32", z, z_fp32, floor,
            1.5)
    if weight_dtype == "int8" or kv_dtype == "int8":
        report["int8"] = int8_decode_checks(cfg, params, served, seed=seed,
                                            kv_dtype=kv_dtype,
                                            frames=pk.get("frames"))
    del params, served
    torch.cuda.empty_cache()
    return report


def phase_serve():
    """Every served configuration at full width and depth behind
    max_seq 512 (paged KV only: the first wave reaches 332 positions,
    split-KV partials; the second stays under 256, one normalized pass;
    GPT3-XL with SERVE_ENCODES interleaved),
    then gemma3-27b at max_seq 2048, where its 52 local layers keep ring
    caches, and hymba cut to one global and three local layers at max_seq
    2048, its ring case.  Both long-context runs hold a context past 1000
    positions in every decode step, so the paged decode always splits."""
    import dataclasses

    from repro_torch.configs import (GEMMA3_27B, GPT3_XL, GPT_J, HYMBA_1_5B,
                                     MAMBA2_2_7B, PHI4_MINI)
    out = {cfg.name: serve_model(cfg, seed=seed,
                                 prefill_profile=cfg.has_ssm)
           for seed, cfg in enumerate((GPT_J, PHI4_MINI, HYMBA_1_5B,
                                       MAMBA2_2_7B))}
    # the paper's other decoder, its generate traffic mixed with encodes
    out[GPT3_XL.name] = serve_model(GPT3_XL, seed=7, encodes=SERVE_ENCODES)
    # two prompts prefill past the window (the ring is rolled at
    # admission); the 1010 prompt crosses position 1024 while it decodes
    # (the ring wraps in place)
    out[GEMMA3_27B.name] = serve_model(
        GEMMA3_27B, seed=4, max_seq=2048,
        lengths=(1100, 40, 1010, 300, 20, 90, 1030, 150))
    hymba = dataclasses.replace(
        HYMBA_1_5B, n_layers=4,
        schedule=(("hybrid_attn", 1), ("hybrid_local", 3)))
    out["hymba-1.5b ring"] = serve_model(hymba, seed=5, max_seq=2048,
                                         lengths=(1100, 300, 1010))
    return out


def phase_serve_int8(bf16):
    """GPT-J (LayerNorm + GELU: the plain GEMM's int8 form) and
    phi4-mini-3.8b (RMSNorm + SwiGLU + GQA 24 / 8: the gated GEMM's int8
    form) at full width and depth with `weight_dtype="int8",
    kv_dtype="int8"`, the bf16 serve runs' batch (4), max_seq (512) and
    8 requests, then the int8 decode checks (`int8_decode_checks`).  Each
    run's weight and KV bytes, AR / NAR tok/s, decode-step device time
    and peak memory are printed beside the same config's bf16 run
    (`bf16`: phase_serve's reports)."""
    from repro_torch.configs import GPT_J, PHI4_MINI
    out = {}
    for seed, cfg in ((0, GPT_J), (1, PHI4_MINI)):
        r = serve_model(cfg, seed=seed, weight_dtype="int8", kv_dtype="int8")
        b = bf16[cfg.name]
        rows = {}
        for key, (st, rep) in {"bf16": (b["stats"], b),
                               "int8": (r["stats"], r)}.items():
            prof = rep["decode_profile"]
            rows[key] = {
                "weight_gb": st["weight_bytes_per_device"] / 1e9,
                "kv_gb": st["kv_pool_bytes"] / 1e9,
                "ar_tok_s": st["ar_tok_s"], "nar_tok_s": st["nar_tok_s"],
                "step_ms": prof["step_ms"],
                "device_busy_ms": prof.get("device_busy_ms"),
                "busy_share": prof.get("busy_share"),
                "peak_gb": rep["peak_memory_gb"]}
        for key, v in rows.items():
            log(f"  [{cfg.name} {key}] weights {v['weight_gb']:.3f} GB, KV "
                f"{v['kv_gb']:.3f} GB | AR {v['ar_tok_s']:.1f} tok/s, NAR "
                f"{v['nar_tok_s']:.1f} tok/s | decode step (200-token "
                f"prompts) {v['step_ms']:.2f} ms, device busy "
                f"{_ms(v['device_busy_ms'])} | peak {v['peak_gb']:.2f} GB")
        r["vs_bf16"] = rows
        out[cfg.name] = r
    return out


SERVE_CLI = ["--arch", "gpt-j", "--requests", "6", "--batch", "4",
             "--prompt-len", "160", "--min-prompt-len", "40", "--max-new",
             "12", "--max-seq", "256", "--seed", "11"]


def phase_serve_cli():
    """The port's CLI, `python -m repro_torch.launch.serve` (its `main`, in
    this process), at GPT-J's full width and depth: 6 sampled generate
    requests, then 6 encode requests (pooling `last`).  Each run's kernels
    must launch (the generate run decoding through its captured graph) and
    its summary lines print; then the int8 run (`--weight-dtype int8
    --kv-dtype int8`), whose summary must show its QUANT part and whose
    GEMM and paged launches must all be int8 forms, and the chunked run
    (`--policy chunked --prefill-chunk 32`, the prefix cache at its
    default, on), whose prompts over 32 tokens prefill in pieces, at
    GPT-J's, GPT3-XL's and phi4-mini's full width and depth, and the
    token-tree speculative run (`--spec-draft auto --spec-k 4
    --spec-branches 3`), whose summary must print its spec line.  Every
    run has the prefix cache on, the CLI's default."""
    import contextlib
    import io

    from repro_torch.configs import GPT3_XL, GPT_J, PHI4_MINI
    from repro_torch.launch import serve
    sampled = SERVE_CLI + ["--temperature", "0.8", "--top-k", "40"]
    chunked = sampled + ["--policy", "chunked", "--prefill-chunk", str(CHUNK)]

    def chunk_need(cfg):
        # every prompt (40-160 tokens) is over the budget: no whole-prompt
        # pass, so no flash launch
        return tuple(k for k in path_kernels(cfg, "serve", max_seq=256)
                     if k != "flash_attention") + ("paged_chunk_partials",)
    runs = {"generate": (sampled, path_kernels(GPT_J, "serve", max_seq=256),
                         "decode step captured"),
            "int8": (sampled + ["--weight-dtype", "int8", "--kv-dtype",
                                "int8"],
                     path_kernels(GPT_J, "serve", max_seq=256),
                     "QUANT w=int8 kv=int8"),
            "chunked": (chunked, chunk_need(GPT_J), "chunks, decode-stall"),
            # speculation never runs the paged decode: draft steps run the
            # dense kernel, verify passes the chunk partials
            "spec": (sampled + ["--spec-draft", "auto", "--spec-k", "4",
                                "--spec-branches", "3"],
                     ("decode_attention", "flash_attention", "fused_matmul",
                      "paged_chunk_partials"), "spec: draft=gpt-j-draft"),
            **{f"chunked {c.name}": (
                ["--arch", c.name] + chunked[2:], chunk_need(c),
                "chunks, decode-stall") for c in (GPT3_XL, PHI4_MINI)},
            "encode": (SERVE_CLI + ["--task", "encode", "--pooling", "last"],
                       ("flash_attention", "fused_matmul", "layernorm"),
                       "ENC")}
    out = {}
    for task, (argv, need, marker) in runs.items():
        buf = io.StringIO()
        label = (f"serve CLI {task}" if argv[1] != "gpt-j"
                 else f"serve CLI gpt-j {task}")

        def main():
            with contextlib.redirect_stdout(buf):
                return serve.main(argv)
        t0 = time.perf_counter()
        rc, launches = drive(label, main, need)
        seconds = time.perf_counter() - t0
        text = buf.getvalue()
        log(f"serve CLI ({task}): python -m repro_torch.launch.serve "
            f"{' '.join(argv)}: exit {rc} in {seconds:.1f} s")
        for line in text.splitlines():
            log(f"  | {line}")
        if rc != 0 or "served 6 requests" not in text or marker not in text:
            raise AssertionError(f"serve CLI ({task}) did not serve its "
                                 f"trace")
        by = TEMPLATE_LAUNCHES[label]
        bf16_forms = (sum(by[k][t] for k in GEMM_WRAPPERS
                          for t in ("stream", "wgmma"))
                      + by["paged_decode_attention"]["bf16"])
        if task == "int8" and bf16_forms:
            raise AssertionError(f"serve CLI (int8) launched {bf16_forms} "
                                 f"bf16 GEMM / paged forms: {by}")
        out[task] = {"argv": argv, "seconds": seconds, "stdout": text,
                     "launches": launches}
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 5b. chunked prefill, the prefix cache and the scheduler policies
# --------------------------------------------------------------------------

CHUNK = 32                      # ChunkedPrefillPolicy's budget (the CLI's)
FORCED_LEN = 300                # the teacher-forced chunked prompt
PREFIX_LEN = 200                # shared prefix: ends inside block 13
PREFIX_TAILS = (16, 48, 24, 40, 32, 20, 44, 28)   # unique tokens a request
PREFIX_SAMPLED = (2, 5)
PREFIX_SUFFIX = 40              # the teacher-forced warm suffix (width 48)


def _serve_requests(cfg, lengths=SERVE_LENGTHS, *, seed=0, uid0=0):
    """serve_model's trace: 32 new tokens each, uids 1 and 6 sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(lengths):
        sp = (SamplingParams(temperature=0.8, top_k=40, seed=100 + i)
              if i in (1, 6) else SamplingParams())
        reqs.append(Request(uid=uid0 + i, prompt=rng.integers(
            0, cfg.vocab, n, dtype=np.int32), max_new_tokens=32,
            sampling=sp))
    return reqs


def _prefix_requests(cfg, *, uid0=0, seed=21):
    """8 requests sharing a PREFIX_LEN-token prefix, each with its own
    tail of PREFIX_TAILS tokens; 24 new tokens; PREFIX_SAMPLED sample.
    A copy with other uids draws the same tokens (seed = index)."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, PREFIX_LEN, dtype=np.int32)
    return [Request(uid=uid0 + i, prompt=np.concatenate(
        [shared, rng.integers(0, cfg.vocab, n, dtype=np.int32)]),
        max_new_tokens=24,
        sampling=(SamplingParams(temperature=0.8, top_k=40, seed=200 + i)
                  if i in PREFIX_SAMPLED else SamplingParams()))
        for i, n in enumerate(PREFIX_TAILS)]


def _serve_numbers(st):
    """The metrics the chunk / prefix runs are compared by."""
    return {"nar_tok_s": st.nar_tok_s, "ar_tok_s": st.ar_tok_s,
            "ttft_p50_ms": st.ttft_p50_ms, "ttft_p95_ms": st.ttft_p95_ms,
            "decode_step_p50_ms": st.decode_step_p50_ms,
            "decode_step_p95_ms": st.decode_step_p95_ms,
            "decode_stall_p95_ms": st.decode_stall_p95_ms,
            "decode_stall_max_ms": max(st.decode_stall_ms, default=0.0),
            "decode_stall_total_ms": sum(st.decode_stall_ms),
            "prefill_batches": st.prefill_batches,
            "prefill_chunks": st.prefill_chunks,
            "decode_steps": st.decode_steps,
            "blocks_per_token": st.blocks_per_token}


def _log_numbers(label, n):
    log(f"  [{label}] NAR {n['nar_tok_s']:.1f} tok/s | AR "
        f"{n['ar_tok_s']:.1f} tok/s | TTFT p50 {n['ttft_p50_ms']:.1f} ms "
        f"p95 {n['ttft_p95_ms']:.1f} ms | decode step p50 "
        f"{n['decode_step_p50_ms']:.2f} ms p95 "
        f"{n['decode_step_p95_ms']:.2f} ms | decode stall p95 "
        f"{n['decode_stall_p95_ms']:.2f} ms max "
        f"{n['decode_stall_max_ms']:.2f} ms total "
        f"{n['decode_stall_total_ms']:.1f} ms | {n['prefill_batches']} "
        f"prefill passes, {n['prefill_chunks']} chunk passes, "
        f"{n['decode_steps']} decode steps, "
        f"{n['blocks_per_token']:.2f} pool positions a live token")


def _check_served(eng, done, n, new_tokens, label):
    """Every request finished with its tokens, inside the vocabulary, and
    no block leaked (the prefix cache's own blocks apart)."""
    cfg = eng.runner.cfg
    if len(done) != n:
        raise AssertionError(f"{label}: {len(done)} of {n} finished")
    for r in done:
        if len(r.output) != new_tokens or not all(
                0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"{label}: request {r.uid} gave "
                                 f"{r.output}")
    held = eng.prefix_cache.cached_blocks if eng.prefix_cache else 0
    if eng.allocator.num_free != eng.allocator.num_blocks - held:
        raise AssertionError(f"{label}: KV blocks leaked")


def _graph_mid_flight(eng, cfg, reqs, want, label):
    """Submit `reqs`, step the engine until `want(runner)` holds (a slot
    parked mid-prefill beside decoding slots; decoding slots after a
    copy-on-write), hold the captured decode step to the eager one there
    (`check_graph_vs_eager`), then drain the engine."""
    for r in reqs:
        eng.submit(r)
    for _ in range(200):
        eng.step()
        if eng.runner.decoding_slots() and want(eng.runner):
            break
    else:
        raise AssertionError(f"{label}: the state to check never came")
    torch.cuda.synchronize()
    out = check_graph_vs_eager(eng, cfg)
    out["parked_slots"] = int(sum(eng.runner.prefilling))
    eng.run()
    return out


def _staggered(eng, cfg, label):
    """The trace chunked prefill is for: three short requests (prompts of
    20, 30 and 25 tokens) decoding, then a FORCED_LEN-token prompt
    admitted beside them.  -> the numbers of that run alone (the stats
    reset first), the late request's TTFT among them."""
    short = _serve_requests(cfg, (20, 30, 25), uid0=80)
    late = _serve_requests(cfg, (FORCED_LEN,), seed=3, uid0=90)[0]
    eng.reset_stats()
    for r in short:
        eng.submit(r)
    for _ in range(50):
        if all(r.output for r in short):
            break
        eng.step()
    else:
        raise AssertionError(f"{label}: the short requests never decoded")
    eng.submit(late)
    eng.run()
    _check_served(eng, eng.completed[-4:], 4, 32, label)
    nums = _serve_numbers(eng.stats())
    nums["late_ttft_ms"] = late.ttft_ms
    _log_numbers(label, nums)
    return nums


def prefill_logits(cfg, params, tokens, ends, *, mode, policy,
                   max_seq=512):
    """Logits [len(ends), vocab] fp32 of one prompt's whole-prompt prefill
    stack (fused) at the positions `ends`, under a kernel mode."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    tok = torch.tensor(tokens[None], device=DEVICE)
    with ops.kernel_mode(mode), torch.no_grad():
        x = lm._embed_sequence(params, tok, policy=policy)
        x, _ = lm._run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                        max_seq=max_seq, fused=True,
                                        compact_kv=True)
        return _head(params, cfg, x[0, list(ends)], fused=True,
                     policy=policy)


def chunk_logits(cfg, params, tokens, *, chunk, prefix_len=0, policy,
                 kv_dtype=None, max_seq=512, block_size=16):
    """Teacher-forced chunk stack (fused, `auto` kernels): the first
    `prefix_len` tokens prefilled whole and scattered into the decode
    caches' pools (a cold admission; int8 pools quantized on write), the
    block the prefix ends inside copied on write into a spare block (as a
    warm admission does), then the rest in pieces of `chunk` through the
    chunk stack.  -> (logits [pieces, vocab] fp32 at each piece's last
    position, those positions, and a callable that runs the last piece
    again through the chunk step: the same writes, so the caches keep
    their values)."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serving.kv_cache import block_copy, prefill_scatter
    dev = torch.device(DEVICE)
    MB = -(-max_seq // block_size)
    layout = steps.make_paged_layout(cfg, max_seq, MB + 1, block_size)
    table = torch.arange(MB, dtype=torch.int32, device=dev)[None]
    caches = steps.cache_layout(cfg, layout, batch_size=1, policy=policy,
                                device=dev, kv_dtype=kv_dtype)
    step = steps.make_chunk_prefill_step(cfg, policy=policy, layout=layout,
                                         chunk_tokens=chunk)
    tok = torch.tensor(tokens, device=dev)
    rows, ends = [], []
    with torch.no_grad():
        if prefix_len:
            x = lm._embed_sequence(params, tok[None, :prefix_len],
                                   policy=policy)
            _, group = lm._run_segments_prefill(
                params, x, cfg=cfg, policy=policy, max_seq=max_seq,
                fused=True, compact_kv=True)
            prefill_scatter(caches, group, torch.zeros(
                1, dtype=torch.int64, device=dev), table,
                block_size=block_size, paged_segments=layout.segments)
            del group
            if prefix_len % block_size:
                e = prefix_len // block_size
                block_copy(caches, int(table[0, e]), MB, layout.segments)
                table[0, e] = MB
        for start in range(prefix_len, len(tokens), chunk):
            take = min(chunk, len(tokens) - start)
            piece = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
            piece[0, :take] = tok[start:start + take]
            args = (piece, torch.tensor([start], device=dev),
                    torch.tensor([take], device=dev))
            x, _, _ = lm._run_chunk_stack(params, *args, caches, table,
                                          cfg=cfg, policy=policy,
                                          paged_segments=layout.segments)
            rows.append(_head(params, cfg, x[:, take - 1], fused=True,
                              policy=policy))
            ends.append(start + take - 1)

    @torch.no_grad()
    def again():
        return step.fn(params, *args, caches, table, None)
    return torch.cat(rows), ends, again


def profile_chunk_pass(cfg, one, width, pos0, what="chunk"):
    """One chunk pass (`one`; `what`: "verify" for a speculative verify
    pass on the same stack): its wall time (host clock, 5 passes), the
    device's busy time and events a pass (torch.profiler, 3 passes), and
    the hand kernels it launches (counters)."""
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 5
    dev_k = device_kernels(one, iters=3)
    busy = sum(ms for ms, _ in dev_k.values()) if dev_k else None
    _, launches = drive(f"{cfg.name} one {what} pass", one,
                        ("fused_matmul", "paged_chunk_partials"))
    prof = {"width": width, "pos0": pos0, "wall_ms": wall,
            "device_busy_ms": busy,
            "device_events": sum(n for _, n in dev_k.values()),
            "hand_launches": {k: n for k, n in launches.items() if n},
            "top": sorted(((k, ms, n) for k, (ms, n) in dev_k.items()),
                          key=lambda r: -r[1])[:6]}
    log(f"  one {what} pass (width {width}, pos0 {pos0}): wall "
        f"{wall:.2f} ms, device busy {_ms(busy)}"
        f"{f' ({busy / wall:.1%})' if busy else ''}, "
        f"{prof['device_events']} device events, hand-kernel launches "
        f"{prof['hand_launches']}")
    for k_, ms, n_ in prof["top"]:
        log(f"    device {ms:8.3f} ms  x{n_:<4d} {k_[:80]}")
    return prof


def check_chunk_partials_op():
    """`ops.paged_chunk_partials` (the oracle's device torch ops; the
    reference has no Pallas kernel for it) at GPT-J's heads, C = 32
    queries at positions 268..299 over 300 pooled positions (19 of 32
    table entries, BS 16): its result, normalized, against SDPA on the
    same gathered K / V; its time with the wrapper (CUDA events) and on
    the device (profiler), the device events of a call, SDPA's time, and
    the byte bound (q, the 300 positions' K / V, o / m / l once)."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=DEVICE)
    g.manual_seed(12)
    H, KV, D, BS, C, L = 16, 16, 256, 16, 32, FORCED_LEN
    MB, NB = 512 // BS, 64
    dev = torch.device(DEVICE)
    q = torch.randn((1, C, H, D), generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn((NB, BS, KV, D), generator=g,
                          device=dev).bfloat16() for _ in range(2))
    tab = torch.full((1, MB), -1, dtype=torch.int32, device=dev)
    n = -(-L // BS)
    tab[0, :n] = torch.randperm(NB, generator=g, device=dev)[:n].int()
    q_pos = (L - C + torch.arange(C, device=dev))[None]
    lengths = torch.tensor([L], dtype=torch.int32, device=dev)
    args = (q, kp, vp, tab, q_pos, lengths)
    op = lambda: ops.paged_chunk_partials(*args)
    o, m, l = op()
    k = kp[tab[0, :n].long()].reshape(1, n * BS, KV, D)[:, :L].transpose(
        1, 2).contiguous()
    v = vp[tab[0, :n].long()].reshape(1, n * BS, KV, D)[:, :L].transpose(
        1, 2).contiguous()
    mask = torch.arange(L, device=dev)[None, :] <= q_pos[0][:, None]
    qs = q.transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask)
    y = sdpa().transpose(1, 2).float()
    sdpa_err = rel_err(o / l[..., None], y)[1]
    ms, lib = time_ms(op), time_ms(sdpa)
    dev_ms, lib_dev = device_ms([op]), device_ms([sdpa])
    events = device_events(op)
    nbytes = (q.numel() * 2 + 2 * L * KV * D * 2 + o.numel() * 4
              + 2 * m.numel() * 4)
    flops = 4 * C * H * L * D
    b_ms, b_by = bound_ms(nbytes, flops)
    out = {"case": f"C={C} over {L} positions, {H}x{D}, BS {BS}",
           "rel_err_vs_sdpa": sdpa_err,
           "ms": ms, "device_ms": dev_ms, "device_events": events,
           "library_ms": lib, "library_device_ms": lib_dev,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  ops.paged_chunk_partials {out['case']}: rel err, "
        f"normalized, vs SDPA {sdpa_err:.2e}; {ms:.4f} ms with "
        f"the wrapper, device {_ms(dev_ms)} in {events:.0f} device events a"
        f" call | SDPA {lib:.4f} ms (device {_ms(lib_dev)}) | bound "
        f"{b_ms:.4f} ms ({b_by})")
    if not sdpa_err <= ATTN_TOL:
        raise AssertionError("ops.paged_chunk_partials disagrees")
    return out


def phase_chunk_prefix():
    """GPT-J at full width and depth (28 layers, E 4096, bf16, batch 4,
    max_seq 512, block 16):
      chunked  SERVE_LENGTHS under ChunkedPrefillPolicy(32), then under
               FCFS (all at t = 0: chunking's throughput cost), then a
               staggered trace (a 300-token prompt admitted while three
               slots decode: the stall chunking bounds), each: every
               request served, no leak; SERVE_LENGTHS: exact launch counts
               (chunk passes by width: GEMMs per pass and form, the chunk
               partials once a layer a pass, flash only in whole-prompt
               passes); the captured decode step held to the eager one with
               a slot parked mid-prefill; a 300-token prompt teacher-forced
               through the chunk stack in 32-token pieces, each piece's
               last-position logits held to whole-prompt prefill's by the
               floor-scaled gate (k = 2 of the plain bf16 / fp32 gap);
      prefix   8 requests sharing a 200-token prefix (the first served
               before the rest arrive): hit rate >= 7/8, >= 7 x 192 cached
               tokens, >= 1 copy-on-write, the index's invariants, no leak
               after clear(); the graph held to the eager step after
               copies; a warm suffix pass (prefix prefilled whole, its
               tail block copied, 40 tokens at width 48) held to the cold
               whole-prompt prefill by the same gate; the trace again with
               the cache off;
      int8     the prefix trace with int8 weights and KV: int8 GEMM and
               paged forms only, each copy's k / v / ks / vs bit-equal to
               its source, and the int8 warm suffix pass held to the int8
               whole-prompt prefill;
      others   GPT3-XL and phi4-mini at full width and depth, the prefix
               trace under ChunkedPrefillPolicy(32) with the cache on, bf16
               and int8 KV: the serve, count and prefix gates above;
    then one chunk pass profiled (wall, device busy, events, hand-kernel
    launches) and `ops.paged_chunk_partials` timed against SDPA and its
    bound (`check_chunk_partials_op`)."""
    from repro_torch.configs import GPT_J
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.models import lm
    from repro_torch.serving import ChunkedPrefillPolicy, InferenceEngine
    from repro_torch.serving import runner as runner_mod
    cfg = GPT_J
    t_phase = time.perf_counter()
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=0)
    out = {"chunked": {}, "prefix": {}}
    engine = lambda **kw: InferenceEngine(
        cfg, params, batch_size=4, max_seq=512, block_size=16, policy=BF16,
        device=DEVICE, **kw)

    def served(label, eng, run, n, new_tokens, need):
        done, launches = drive(label, run, need)
        st = eng.stats()
        by = TEMPLATE_LAUNCHES[label]
        cfg_ = eng.runner.cfg
        _check_served(eng, done, n, new_tokens, label)
        check_serve_counts(cfg_, launches, st, 512, by=by,
                           kv_int8=st.kv_dtype == "int8")
        check_gemm_templates(cfg_, st, by, int8=st.weight_dtype == "int8",
                             chunks=chunk_passes(eng))
        nums = _serve_numbers(st)
        _log_numbers(label, nums)
        return {"numbers": nums, "stats": st.to_dict(),
                "chunk_passes": chunk_passes(eng), "launches": launches,
                "outputs": {r.uid: r.output for r in done}}

    # -- chunked prefill against FCFS ----------------------------------
    need = path_kernels(cfg, "serve")
    for name, sched in (("chunked", ChunkedPrefillPolicy(CHUNK)),
                        ("fcfs", None)):
        eng = engine(scheduler=sched)
        for r in _serve_requests(cfg):
            eng.submit(r)
        label = f"gpt-j {name} serve"
        out["chunked"][name] = served(
            label, eng, eng.run, len(SERVE_LENGTHS), 32,
            need + (("paged_chunk_partials",) if name == "chunked" else ()))
        if name == "chunked":
            # one slot parked (the sink's one writer: rows without a block
            # write their K / V there, and two writers' order is not
            # fixed), three decoding
            out["chunked"]["graph_vs_eager_parked"] = _graph_mid_flight(
                eng, cfg, _serve_requests(cfg, (300, 20, 30, 25),
                                          uid0=50),
                lambda r: any(r.prefilling), "gpt-j chunked")
            _check_served(eng, eng.completed[-4:], 4, 32,
                          "gpt-j chunked, parked check")
        out["chunked"][name]["staggered"] = _staggered(
            eng, cfg, f"gpt-j {name} staggered")
        del eng
        torch.cuda.empty_cache()
    a, b = out["chunked"]["chunked"], out["chunked"]["fcfs"]
    same = sum(a["outputs"][u] == b["outputs"][u] for u in a["outputs"])
    log(f"  [gpt-j] chunked vs fcfs: {same} of {len(a['outputs'])} "
        f"requests with identical tokens (bf16; not gated); the "
        f"SERVE_LENGTHS runs admit every request at t = 0, so FCFS never "
        f"admits while others decode: their numbers show chunking's "
        f"throughput cost only")
    sa, sb = a["staggered"], b["staggered"]
    log(f"  [gpt-j] staggered ({FORCED_LEN}-token prompt admitted while 3 "
        f"slots decode), chunked vs fcfs: decode stall p95 "
        f"{sa['decode_stall_p95_ms']:.2f} vs {sb['decode_stall_p95_ms']:.2f}"
        f" ms, max {sa['decode_stall_max_ms']:.2f} vs "
        f"{sb['decode_stall_max_ms']:.2f} ms, total "
        f"{sa['decode_stall_total_ms']:.1f} vs "
        f"{sb['decode_stall_total_ms']:.1f} ms; the late prompt's TTFT "
        f"{sa['late_ttft_ms']:.1f} vs {sb['late_ttft_ms']:.1f} ms")

    # teacher-forced: a 300-token prompt in 32-token pieces vs prefill
    rng = np.random.default_rng(31)
    prompt = rng.integers(0, cfg.vocab, FORCED_LEN, dtype=np.int32)
    (z_chunk, ends, again), launches = drive(
        "gpt-j teacher-forced chunks",
        lambda: chunk_logits(cfg, params, prompt, chunk=CHUNK, policy=BF16),
        ("fused_matmul", "paged_chunk_partials"))
    prof = profile_chunk_pass(cfg, again, CHUNK, ends[-1] // CHUNK * CHUNK)
    del again
    z_pref = prefill_logits(cfg, params, prompt, ends, mode="auto",
                            policy=BF16)
    z_ref = prefill_logits(cfg, params, prompt, ends, mode="ref",
                           policy=BF16)
    z_fp32 = prefill_logits(cfg, params, prompt, ends, mode="ref",
                            policy=FP32)
    gaps = [_gap(z_ref[i:i + 1], z_fp32[i:i + 1]) for i in range(len(ends))]
    floor = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    log(f"  teacher-forced gpt-j chunks: plain bf16 vs plain fp32 (floor, "
        f"worst of {len(ends)} positions) rel {floor[0]:.2e}, cosine "
        f"{np.cos(floor[1]):.6f}")
    worst = {"rel": 0.0, "cosine": 1.0}
    for i, e in enumerate(ends):
        g_ = _logit_gate(f"gpt-j chunk ending at {e} vs prefill",
                         z_chunk[i:i + 1], z_pref[i:i + 1], floor, 2.0,
                         quiet=True)
        worst = {"rel": max(worst["rel"], g_["rel"]),
                 "cosine": min(worst["cosine"], g_["cosine"]),
                 "tol": g_["tol"], "cos_min": g_["cos_min"]}
    log(f"  teacher-forced gpt-j: {len(ends)} pieces of {CHUNK} vs "
        f"whole-prompt prefill at {ends}: worst rel {worst['rel']:.2e} "
        f"(tol {worst['tol']:.2e}), cosine {worst['cosine']:.6f} (min "
        f"{worst['cos_min']:.6f})")
    out["chunked"]["teacher_forced"] = {
        "ends": ends, "floor": {"rel": floor[0],
                                "cosine": float(np.cos(floor[1]))},
        "worst": worst, "launches": launches}
    out["chunked"]["chunk_pass"] = prof

    # -- prefix cache: warm against cold, bf16 and int8; GPT3-XL and
    # phi4-mini chunked with the cache on, bf16 and int8 KV -------------
    from repro_torch.configs import GPT3_XL, PHI4_MINI
    copies = []

    def spy(caches, src, dst, segments):
        res = block_copy(caches, src, dst, segments)
        copies.append(all(torch.equal(t[:, dst], t[:, src])
                          for seg in caches for t in seg.values()))
        return res

    def prefix_run(label, eng, graph=False):
        """The prefix trace: the first request served to its first token
        before the rest arrive; the cache's gates when it is on."""
        cfg_ = eng.runner.cfg
        reqs = _prefix_requests(cfg_)

        def run():
            eng.submit(reqs[0])
            while not reqs[0].output:
                eng.step()
            for r in reqs[1:]:
                eng.submit(r)
            eng.run()
            return list(eng.completed)
        need = path_kernels(cfg_, "serve")
        if eng.scheduler.chunk_tokens is not None:
            # every prompt is over the budget: no whole-prompt pass, so no
            # flash launch
            need = tuple(k for k in need if k != "flash_attention")
        if eng.prefix_cache is not None or eng.scheduler.chunk_tokens:
            need += ("paged_chunk_partials",)
        n0 = len(copies)
        rep_ = served(label, eng, run, len(reqs), 24, need)
        st = eng.stats()
        rep_["copies_bit_equal"] = copies[n0:]
        if eng.prefix_cache is None:
            return rep_
        eng.prefix_cache.check()
        if not (st.prefix_cache_hit_rate >= 7 / 8
                and st.cached_prefix_tokens >= 7 * 192
                and st.cow_copies >= 1 and all(copies[n0:])):
            raise AssertionError(
                f"{label}: hit rate {st.prefix_cache_hit_rate}, "
                f"{st.cached_prefix_tokens} cached tokens, {st.cow_copies} "
                f"copies, bit-equal {copies[n0:]}")
        if graph:
            rep_["graph_vs_eager_after_cow"] = _graph_mid_flight(
                eng, cfg_, _prefix_requests(cfg_, uid0=100)[:4],
                lambda r: r.cow_copies > st.cow_copies,
                f"{label}, after copies")
            eng.prefix_cache.check()
        eng.prefix_cache.clear()
        if eng.allocator.num_free != eng.allocator.num_blocks:
            raise AssertionError(f"{label}: blocks leaked after clear()")
        log(f"  [{label}] hit rate {st.prefix_cache_hit_rate:.3f}, "
            f"{st.cached_prefix_tokens} cached prompt tokens, "
            f"{st.cow_copies} copies on write (every copy bit-equal, ks / "
            f"vs included), {st.evicted_blocks} evicted; index clean; no "
            f"leak after clear()")
        return rep_

    block_copy = runner_mod.block_copy
    runner_mod.block_copy = spy
    try:
        for name, kw in (("warm", dict(prefix_cache=True)),
                         ("cold", dict(prefix_cache=False)),
                         ("int8 warm", dict(prefix_cache=True,
                                            weight_dtype="int8",
                                            kv_dtype="int8"))):
            eng = engine(**kw)
            out["prefix"][name] = prefix_run(f"gpt-j prefix {name}", eng,
                                             graph=kw["prefix_cache"])
            if name == "int8 warm":
                served_params = eng.runner.params
            del eng
            torch.cuda.empty_cache()
        for cfg_x, seed in ((GPT3_XL, 7), (PHI4_MINI, 1)):
            params_x = lm.init_lm(cfg_x, dtype=torch.bfloat16,
                                  device=DEVICE, seed=seed)
            for kv in (None, "int8"):
                eng = InferenceEngine(
                    cfg_x, params_x, batch_size=4, max_seq=512,
                    block_size=16, policy=BF16, device=DEVICE,
                    scheduler=ChunkedPrefillPolicy(CHUNK), prefix_cache=True,
                    kv_dtype=kv)
                name = f"{cfg_x.name} chunked prefix{' int8 KV' if kv else ''}"
                out["prefix"][name] = prefix_run(name, eng)
                del eng
                torch.cuda.empty_cache()
            del params_x
    finally:
        runner_mod.block_copy = block_copy
    w, c = out["prefix"]["warm"], out["prefix"]["cold"]
    same = sum(w["outputs"][u] == c["outputs"][u] for u in w["outputs"])
    log(f"  [gpt-j] prefix warm vs cold: {same} of {len(w['outputs'])} "
        f"requests with identical tokens (bf16; not gated)")

    # teacher-forced warm suffix passes against whole-prompt prefill
    shared = _prefix_requests(cfg)[1].prompt[:PREFIX_LEN]
    prompt = np.concatenate([shared, rng.integers(
        0, cfg.vocab, PREFIX_SUFFIX, dtype=np.int32)])
    end = [len(prompt) - 1]
    tf = {}
    for name, p_, kv in (("bf16", params, None),
                         ("int8", served_params, "int8")):
        z_ref = prefill_logits(cfg, p_, prompt, end, mode="ref",
                               policy=BF16)
        z_fp32 = prefill_logits(cfg, p_, prompt, end, mode="ref",
                                policy=FP32)
        floor = _gap(z_ref, z_fp32)
        (z_warm, _, _), launches = drive(
            f"gpt-j warm suffix {name}",
            lambda: chunk_logits(cfg, p_, prompt, chunk=48,
                                 prefix_len=PREFIX_LEN, policy=BF16,
                                 kv_dtype=kv),
            ("fused_matmul", "flash_attention", "paged_chunk_partials"))
        z_cold = prefill_logits(cfg, p_, prompt, end, mode="auto",
                                policy=BF16)
        log(f"  teacher-forced gpt-j warm suffix ({name} weights"
            f"{' and KV' if kv else ''}): floor rel {floor[0]:.2e}")
        tf[name] = {"floor": {"rel": floor[0],
                              "cosine": float(np.cos(floor[1]))},
                    "launches": launches,
                    "warm_vs_cold": _logit_gate(
                        f"gpt-j warm suffix ({name}) vs cold prefill",
                        z_warm, z_cold, floor, 2.0)}
    out["prefix"]["teacher_forced"] = tf
    del served_params, params
    torch.cuda.empty_cache()
    out["chunk_partials_op"] = check_chunk_partials_op()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"chunk / prefix phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 5c. speculative decoding
# --------------------------------------------------------------------------

SPEC_K = 4                      # draft tokens a chain round
SPEC_TREE = (3, 3)              # the tree runs: depth k, branches
SPEC_ALPHA = 0.1                # the mid-range draft's share of noise
SPEC_TF_PROMPT = 200            # the teacher-forced verify's prompt ...
SPEC_TF_CONT = 8                # ... and its known continuation
NEAR_TIE_K = 2.0                # a divergence's margin, in bf16 floors


def midrange_draft(cfg, params, alpha=SPEC_ALPHA, seed=1234):
    """The tree gate's draft (the reference's construction,
    tests/test_tree_spec.py, written out for the port): the target's
    embedding, head, final norm and first DRAFT_LAYERS layers, mixed
    (1 - alpha) with alpha of a draft init at another seed (in fp32, cast
    back).  Its top-1 is wrong often enough to reject, while its
    runners-up still carry the target's choice."""
    from repro_torch.models import lm
    from repro_torch.serving.spec import SpecConfig, resolve_draft
    dcfg = resolve_draft(SpecConfig(draft="auto"), cfg)
    other = lm.init_lm(dcfg, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    n = dcfg.n_layers

    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}

    def mix(a, b):
        if isinstance(a, dict):
            return {k: mix(a[k], b[k]) for k in a}
        if isinstance(a, tuple):
            return tuple(mix(x, y) for x, y in zip(a, b))
        return ((1 - alpha) * a.float() + alpha * b.float()).to(a.dtype)
    return mix({"embedding": params["embedding"],
                "final_norm": params["final_norm"],
                "segments": (cut(params["segments"][0]),)}, other)


def draft_agreement(cfg, params, alphas=(0.0, SPEC_ALPHA), n=200):
    """How near the mid-range construction is to the target at full
    depth: one teacher-forced n-token sequence through the target and
    through the draft at each alpha (whole-prompt prefill, kernel path,
    bf16): the share of positions where the draft's top-1 is the target's
    top-1 (what a chain can accept) and where the target's top-1 is among
    the draft's top 3 (what a width-3 tree can)."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving.spec import SpecConfig, resolve_draft
    rng = np.random.default_rng(47)
    seq = rng.integers(0, cfg.vocab, n, dtype=np.int32)
    ends = list(range(n))
    want = prefill_logits(cfg, params, seq, ends, mode="auto",
                          policy=BF16).argmax(-1)
    dcfg = resolve_draft(SpecConfig(draft="auto"), cfg)
    out = {}
    for alpha in alphas:
        z = prefill_logits(dcfg, midrange_draft(cfg, params, alpha), seq,
                           ends, mode="auto", policy=BF16)
        top1 = float((z.argmax(-1) == want).float().mean())
        top3 = float((torch.topk(z, 3, dim=-1).indices == want[:, None])
                     .any(-1).float().mean())
        out[alpha] = {"top1": top1, "top3": top3}
        log(f"  [{cfg.name} mid-range draft, alpha {alpha}] over {n} "
            f"teacher-forced positions: draft top-1 = target top-1 at "
            f"{top1:.3f}, target top-1 in the draft's top 3 at {top3:.3f}")
    return out


def verify_logits(cfg, params, prompt, chunk, *, mode, policy, tree=None,
                  rows=4, max_seq=512, block_size=16):
    """Logits [C, vocab] fp32 of one teacher-forced verify pass: `prompt`
    prefilled into the pools of `rows` identical slots (so the pass's
    GEMMs run at M = rows x C, as an engine's do), then `chunk` (C tokens,
    or a tree's nodes with `tree` = (depth [C], anc [C, C])) through the
    chunk stack at pos0 = len(prompt), the head at every position of row
    0."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.serving.kv_cache import prefill_scatter
    dev = torch.device(DEVICE)
    MB = -(-max_seq // block_size)
    layout = steps.make_paged_layout(cfg, max_seq, rows * MB, block_size)
    table = torch.arange(rows * MB, dtype=torch.int32,
                         device=dev).reshape(rows, MB)
    n, C = len(prompt), len(chunk)
    with ops.kernel_mode(mode), torch.no_grad():
        caches = steps.cache_layout(cfg, layout, batch_size=rows,
                                    policy=policy, device=dev)
        tok = torch.tensor(np.tile(prompt, (rows, 1)), device=dev)
        x = lm._embed_sequence(params, tok, policy=policy)
        _, group = lm._run_segments_prefill(
            params, x, cfg=cfg, policy=policy, max_seq=max_seq, fused=True,
            compact_kv=True)
        prefill_scatter(caches, group, torch.arange(rows, device=dev), table,
                        block_size=block_size,
                        paged_segments=layout.segments)
        del group
        kw = {}
        if tree is not None:
            depth, anc = tree
            kw = dict(rope_pos=n + torch.tensor(np.tile(depth, (rows, 1)),
                                                device=dev),
                      tree_mask=torch.tensor(np.tile(anc, (rows, 1, 1)),
                                             device=dev))
        xc, _, _ = lm._run_chunk_stack(
            params, torch.tensor(np.tile(chunk, (rows, 1)), device=dev),
            torch.full((rows,), n, device=dev),
            torch.full((rows,), C, device=dev), caches, table, cfg=cfg,
            policy=policy, paged_segments=layout.segments, **kw)
        return _head(params, cfg, xc[0], fused=True, policy=policy)


def spec_teacher_forced(cfg, params):
    """A SPEC_TF_PROMPT-token prompt and SPEC_TF_CONT known continuation
    tokens: `forward_verify`'s stack over a k + 1 = 5 chunk at pos0 =
    SPEC_TF_PROMPT on the kernel path, its logits at each position held to
    (a) five eager decode steps on the kernel path (`decode_logits`) and
    (b) the plain (`ref`) verify pass in bf16, both by the floor-scaled
    gate (k = 2 of plain bf16 vs plain fp32, worst position) and by
    `flip_rule` (argmax flips against plain fp32, with plain bf16's own as
    the control); then the tree pass on a width-3 tree whose chain is the
    continuation: its chain nodes' logits bit-equal to the chain pass's,
    or within the same gate."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.serving.spec import build_tree
    rng = np.random.default_rng(41)
    seq = rng.integers(0, cfg.vocab, SPEC_TF_PROMPT + SPEC_TF_CONT,
                       dtype=np.int32)
    prompt, C = seq[:SPEC_TF_PROMPT], SPEC_K + 1
    chunk = seq[SPEC_TF_PROMPT:SPEC_TF_PROMPT + C]
    name = f"{cfg.name} verify, pos0 {SPEC_TF_PROMPT}"
    z_v, launches = drive(f"{name} kernel path",
                          lambda: verify_logits(cfg, params, prompt, chunk,
                                                mode="auto", policy=BF16),
                          ("fused_matmul", "paged_chunk_partials"))
    z_ref = verify_logits(cfg, params, prompt, chunk, mode="ref",
                          policy=BF16)
    z_32 = verify_logits(cfg, params, prompt, chunk, mode="ref", policy=FP32)
    z_dec = decode_logits(cfg, params, seq[:SPEC_TF_PROMPT + C],
                          SPEC_TF_PROMPT, mode="auto", fused=True,
                          policy=BF16, max_seq=512)
    gaps = [_gap(z_ref[i:i + 1], z_32[i:i + 1]) for i in range(C)]
    floor = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    out = {"floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))},
           "launches": launches}
    for ref_name, want in (("eager decode steps", z_dec),
                           ("plain bf16 verify", z_ref)):
        worst = {"rel": 0.0, "cosine": 1.0}
        for i in range(C):
            g = _logit_gate(f"{name} position {i} vs {ref_name}",
                            z_v[i:i + 1], want[i:i + 1], floor, 2.0,
                            quiet=True)
            worst = {"rel": max(worst["rel"], g["rel"]),
                     "cosine": min(worst["cosine"], g["cosine"]),
                     "tol": g["tol"], "cos_min": g["cos_min"]}
        log(f"  teacher-forced {name}: {C} positions vs {ref_name}: worst "
            f"rel {worst['rel']:.2e} (tol {worst['tol']:.2e}), cosine "
            f"{worst['cosine']:.6f} (min {worst['cos_min']:.6f})")
        out[ref_name] = worst
    flips = flip_rule(z_v, z_32, z_ref)
    log(f"  {name}: argmax flips vs plain fp32 {flips['flips']}/{C}, plain "
        f"bf16's {flips['noise_flips']}/{C}: "
        f"{'pass' if flips['ok'] else 'FAIL'}")
    if not flips["ok"]:
        raise AssertionError(f"{name}: flip rule {flips}")
    out["flips"] = flips
    # the tree: chain = the continuation, two random siblings a depth
    levels = [[int(chunk[d])] + [int(t) for t in rng.integers(
        0, cfg.vocab, 2)] for d in range(1, C)]
    tree = build_tree(int(chunk[0]), levels)
    z_t, _ = drive(f"{name} tree kernel path",
                   lambda: verify_logits(cfg, params, prompt, tree.tokens,
                                         mode="auto", policy=BF16,
                                         tree=(tree.depth, tree.anc)),
                   ("fused_matmul", "paged_chunk_partials"))
    chain = np.flatnonzero(tree.chain)
    bit_equal = bool(torch.equal(z_t[chain], z_v))
    worst = {"rel": 0.0, "cosine": 1.0}
    for i, node in enumerate(chain):
        g = _logit_gate(f"{name} tree node {node} vs chain position {i}",
                        z_t[node:node + 1], z_v[i:i + 1], floor, 2.0,
                        quiet=True)
        worst = {"rel": max(worst["rel"], g["rel"]),
                 "cosine": min(worst["cosine"], g["cosine"])}
    log(f"  teacher-forced {name}: width-3 tree ({tree.n_nodes} nodes) at "
        f"its chain nodes {chain.tolist()} vs the chain pass: bit-equal "
        f"{bit_equal}, worst rel {worst['rel']:.2e}, cosine "
        f"{worst['cosine']:.6f}")
    out["tree"] = {"nodes": tree.n_nodes, "bit_equal": bit_equal, **worst}
    return out


def check_sample_topn():
    """`sample_topn` on the card against the CPU on the same logits:
    integer-valued x and unembedding (every logit exact in both), so the
    greedy rows hold exact ties (row 0's top value five ways), at GPT-J's
    vocabulary; rows greedy, sampled top-k 40, sampled top-k 2 (fewer kept
    ids than n) and sampled full vocabulary.  Ids identical."""
    from repro_torch.configs import GPT_J
    from repro_torch.core.embedding import sample_topn
    from repro_torch.core.precision import FP32
    from repro_torch.kernels import ops
    rng = np.random.default_rng(43)
    E, V, n = 256, GPT_J.padded_vocab, 4
    x = rng.integers(-2, 3, (5, E)).astype(np.float32)
    unemb = rng.integers(-1, 2, (E, V)).astype(np.float32)
    unemb[:, 7] = np.sign(x[0])
    unemb[:, 40:44] = unemb[:, 7:8]
    lane = {"temperature": np.array([0, 0, 0.8, 1.3, 0.7], np.float32),
            "top_k": np.array([0, 5, 40, 2, 0], np.int32),
            "seed": np.array([3, 4, 5, 6, 7], np.int32),
            "step": np.array([9, 10, 11, 12, 13], np.int32)}
    got = {}
    for dev in (DEVICE, "cpu"):
        with ops.kernel_mode("ref"), torch.no_grad():
            got[dev] = [t.cpu() for t in sample_topn(
                torch.tensor(x, device=dev), torch.tensor(unemb, device=dev),
                {k: torch.tensor(v, device=dev) for k, v in lane.items()},
                n, cfg=GPT_J, policy=FP32)]
    same = all(torch.equal(a, b) for a, b in zip(got[DEVICE], got["cpu"]))
    ties = got[DEVICE][1][0].tolist()
    log(f"  sample_topn card vs CPU (exact ties in row 0: {ties}): ids "
        f"identical {same}")
    if not same or ties != [7, 40, 41, 42]:
        raise AssertionError(f"sample_topn differs: {got}")
    return {"identical": same, "tied_row": ties}


def check_spec_counts(eng, launches, by, *, replays, verify_passes,
                      draft_prefills, prefill_rows=()):
    """A spec engine's exact launches: the target's prefill passes and the
    draft's (flash once an attention layer a pass, the layers' GEMMs on
    wgmma, the head streaming at M <= 4); each verify pass the chunk
    partials once a target layer and every GEMM, the head included, at
    M = B x C on the template the planner takes for it; each draft step
    one replay of the draft's captured graph: the dense decode kernel once
    a draft layer, its GEMMs and head streaming; and no paged decode
    launch at all (a spec engine never runs `decode()`).  An MoE
    target's expert form: `expert_forms` of its prefill passes' rows
    (`prefill_rows`) and of each verify pass's B x C rows."""
    from repro_torch.configs.base import ATTN_KINDS
    from repro_torch.kernels.matmul import gemm_plan
    r = eng.runner
    st = eng.stats()
    cfg, dcfg = r.cfg, r.draft_cfg
    L = sum(c for k, c in cfg.schedule if k in ATTN_KINDS)
    Ld = sum(c for k, c in dcfg.schedule if k in ATTN_KINDS)
    P, Pd, V, D = st.prefill_batches, draft_prefills, verify_passes, replays
    want = {"decode_attention": Ld * D, "paged_decode_attention": 0,
            "paged_decode_partials": 0, "paged_decode_merge": 0,
            "flash_attention": L * P + Ld * Pd,
            "paged_chunk_partials": L * V,
            "rmsnorm": 0, "layernorm": 0}
    if moe_layers(cfg):
        want["residual_rmsnorm"] = moe_layers(cfg) * (P + V)
    got = {k: launches[k] for k in want}
    pl, pg = gemms_per_pass(cfg)
    dpl, dpg = gemms_per_pass(dcfg)
    step = r.verify_step or r.tree_verify_step
    M = r.B * step.aux["num_tokens"]
    vt = gemm_plan(M, cfg.d_model, cfg.padded_vocab).template
    forms = {"fused_matmul": {"stream": P + Pd + D * (dpl + 1),
                              "wgmma": P * pl + Pd * dpl},
             "fused_matmul_swiglu": {"stream": D * dpg,
                                     "wgmma": (P + V) * pg + Pd * dpg}}
    forms["fused_matmul"][vt] += V * (pl + 1)
    if moe_layers(dcfg):
        raise ValueError(f"check_spec_counts: the MoE draft {dcfg.name} "
                         f"is not counted")
    forms["expert_swiglu"] = expert_forms(cfg, prefill_rows=prefill_rows,
                                          rows_decode=[M] * V)
    for f in forms.values():
        for t in ("fma32", "stream_int8", "wgmma_int8"):
            f.setdefault(t, 0)
    want.update(forms)
    got.update({k: by[k] for k in GEMM_WRAPPERS})
    log(f"  [{cfg.name} spec] {P} target and {Pd} draft prefill passes, "
        f"{V} verify passes (M = {M}: {vt}), {D} draft replays: launches "
        f"{got}, expected {want}")
    if got != want:
        raise AssertionError(f"{cfg.name} spec: launches {got} != {want}")
    return want


def check_draft_graph_vs_eager(eng):
    """The draft's captured step, replayed at the runner's state (its
    slots' draft positions, clamped inside the cache), against an eager
    `forward_decode` (`forward_decode_topk` for a tree draft) on clones of
    the draft's caches: tokens (and runners-up) identical, every cache
    leaf bit-equal.  The caches are restored afterwards."""
    from repro_torch.models import lm
    from repro_torch.serving.sampling import device_lane
    r = eng.runner
    bundle = r.draft_topk_step or r.draft_decode_step
    step = bundle.fn
    if step.graph is None:
        raise AssertionError(f"{r.cfg.name}: the draft step is not captured")
    dev = torch.device(DEVICE)
    pos = np.array([min(ds.pos, r.max_seq - 1) if ds else 0
                    for ds in r.draft_states], np.int32)
    tok = r.tokens.copy()
    saved = _clone_caches(r.draft_caches)
    eager = _clone_caches(r.draft_caches)
    kw = dict(cfg=r.draft_cfg, policy=r.policy,
              block_tables=torch.zeros((r.B, 0), dtype=torch.int32,
                                       device=dev),
              lane=device_lane(r.lane, dev), fused=r.fuse_epilogues,
              paged_segments=r.draft_layout.segments)
    with torch.no_grad():
        res = [t.clone() for t in step(tok, pos, None, r.lane)[:-1]]
        args = (r.draft_params, torch.tensor(tok, device=dev),
                torch.tensor(pos, device=dev), eager)
        if r.draft_topk_step is not None:
            t_e, alts_e, _ = lm.forward_decode_topk(*args,
                                                    n=r.tree_branches, **kw)
            want = [t_e, alts_e]
        else:
            t_e, _ = lm.forward_decode(*args, **kw)
            want = [t_e]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b.to(torch.int32)) for a, b in zip(res, want))
    diffs = [f"segment {i} {k}"
             for i, (sg, se) in enumerate(zip(r.draft_caches, eager))
             for k in sg if not torch.equal(sg[k], se[k])]
    for seg, seg_s in zip(r.draft_caches, saved):
        for k in seg:
            seg[k].copy_(seg_s[k])
    del saved, eager
    log(f"  [{r.cfg.name} draft {r.draft_cfg.name}] captured draft step vs "
        f"eager at draft positions {pos.tolist()}: tokens"
        f"{' and runners-up' if len(res) > 2 else ''} identical {same}, "
        f"cache leaves differing {diffs or 'none'}")
    if not same or diffs:
        raise AssertionError(f"{r.cfg.name}: the draft replay differs from "
                             f"the eager draft step")
    return {"identical": same, "leaves_differing": diffs}


def near_ties(cfg, params, reqs, plain, got, label, *, kv_int8=False):
    """Each request whose spec tokens differ from the plain run's: at the
    first output index i where they differ, the logits of prompt + the
    plain tokens before i (whole-prompt prefill, kernel path, bf16) must
    hold the two tokens within NEAR_TIE_K floors of each other, the floor
    being the largest |dz| of plain bf16 against plain fp32 there (with
    int8 KV, or the int8-KV decode path against the bf16-KV one,
    teacher-forced, if that is larger); a sampled request compares its
    scores (z / T + its Gumbel noise there, top-k kept), times T, or, the
    other near tie of a sampled row, has one of the two tokens' logits
    within NEAR_TIE_K floors of its top-k threshold (the k-th largest
    logit: which ids the mask keeps is then a rounding matter).  Every
    divergence, its kind and its margin are reported; any other fails the
    run."""
    from repro_torch.core.embedding import _lane_scores
    from repro_torch.core.precision import BF16, FP32
    rows = []
    for r in reqs:
        a, b = plain[r.uid], got[r.uid]
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            if len(a) != len(b):
                raise AssertionError(f"{label}: request {r.uid} lengths "
                                     f"{len(a)} vs {len(b)}")
            continue
        seq = np.concatenate([np.asarray(r.prompt, np.int32),
                              np.asarray(a[:i], np.int32)])
        end = [len(seq) - 1]
        z = prefill_logits(cfg, params, seq, end, mode="auto", policy=BF16)
        zr = prefill_logits(cfg, params, seq, end, mode="ref", policy=BF16)
        z32 = prefill_logits(cfg, params, seq, end, mode="ref", policy=FP32)
        floor = float((zr - z32).abs().max())
        if kv_int8:
            n0 = len(r.prompt)
            z8, z16 = (decode_logits(cfg, params, seq, n0, mode="auto",
                                     fused=True, policy=BF16, max_seq=512,
                                     kv_dtype=kv)[-1:]
                       for kv in ("int8", None))
            floor = max(floor, float((z8 - z16).abs().max()))
        sp = r.sampling
        t = sp.temperature if sp.temperature > 0 else 1.0
        if sp.temperature > 0:
            dev = z.device
            lane = {"temperature": torch.tensor([sp.temperature], device=dev),
                    "top_k": torch.tensor([sp.top_k], device=dev),
                    "seed": torch.tensor([sp.seed], device=dev),
                    "step": torch.tensor([len(seq)], device=dev)}
            pad = torch.full((1, cfg.padded_vocab - cfg.vocab), -1e30,
                             device=dev)
            s = _lane_scores(torch.cat([z, pad], 1), lane)[0]
        else:
            s = z[0]
        margin = float(abs(s[a[i]] - s[b[i]])) * t
        kind = "scores" if sp.temperature > 0 else "logits"
        ok = margin <= NEAR_TIE_K * floor
        if not ok and sp.temperature > 0 and sp.top_k > 0:
            kth = torch.topk(z[0], sp.top_k).values[-1]
            edge = min(float(abs(z[0, a[i]] - kth)),
                       float(abs(z[0, b[i]] - kth)))
            if edge <= NEAR_TIE_K * floor:
                ok, margin, kind = True, edge, "top-k threshold"
        rows.append({"uid": r.uid, "index": i, "plain": int(a[i]),
                     "spec": int(b[i]), "margin": margin, "kind": kind,
                     "floor": floor, "sampled": sp.temperature > 0,
                     "near_tie": ok})
        log(f"  [{label}] request {r.uid} first differs at output {i}: "
            f"plain {a[i]} vs spec {b[i]}, margin {margin:.4f} ({kind}), "
            f"bf16 floor {floor:.4f}: "
            f"{'near tie' if ok else 'NOT a near tie'}")
        if not ok:
            raise AssertionError(f"{label}: request {r.uid} diverges at "
                                 f"output {i} with margin {margin} > "
                                 f"{NEAR_TIE_K} x {floor}")
    log(f"  [{label}] {len(reqs) - len(rows)} of {len(reqs)} requests "
        f"token-identical to plain decode, {len(rows)} diverging at a near "
        f"tie")
    return rows


def _spec_numbers(st, wall):
    return {"acceptance_rate": st.spec_acceptance_rate,
            "tokens_per_target_step": st.spec_tokens_per_step,
            "verify_positions": st.verify_positions,
            "spec_rounds": st.spec_rounds,
            "draft_p50_ms": st.draft_time_ms_p50,
            "draft_p95_ms": st.draft_time_ms_p95,
            "branch_utilization": st.spec_branch_utilization,
            "branch_hits": st.spec_branch_hits,
            "tree_nodes": st.spec_tree_nodes,
            "verify_p50_ms": st.decode_step_p50_ms,
            "ar_tok_s": st.ar_tok_s, "ar_tokens": st.ar_tokens,
            "draft_time_s": st.spec_draft_time_s,
            "wall_s": wall, "tokens_per_wall_s": st.ar_tokens / wall}


def spec_engine_run(label, cfg, params, plain, *, spec, draft_params=None,
                    kv_dtype=None, mid_flight=False):
    """One spec engine over SERVE_LENGTHS (32 new tokens, two requests
    sampled): served, drained, exact launches (`check_spec_counts`), each
    request against the plain run (`near_ties`), the round statistics;
    with `mid_flight`, then a second trace stepped until every slot
    decodes, where the draft's replay is held to its eager step and one
    verify pass and one draft step are profiled."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import InferenceEngine
    from repro_torch.serving import runner as runner_mod
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          spec=spec, draft_params=draft_params,
                          kv_dtype=kv_dtype)
    r = eng.runner
    bundle = r.draft_topk_step or r.draft_decode_step
    if not bundle.aux["captured"]:
        raise AssertionError(f"{label}: the draft step is not captured")
    reqs = _serve_requests(cfg)
    for q in reqs:
        eng.submit(q)
    accepts = []
    accept_length = runner_mod.accept_length

    def spy(proposed, target):
        j = accept_length(proposed, target)
        accepts.append((j, len(proposed)))
        return j
    runner_mod.accept_length = spy
    replays0 = bundle.fn.replays
    step = r.verify_step or r.tree_verify_step
    verify0 = step.aux["calls"]
    t0 = time.perf_counter()
    try:
        done, launches = drive(label, eng.run,
                               ("fused_matmul", "flash_attention",
                                "decode_attention", "paged_chunk_partials"))
    finally:
        runner_mod.accept_length = accept_length
    wall = time.perf_counter() - t0
    st = eng.stats()
    _check_served(eng, done, len(reqs), 32, label)
    counts = check_spec_counts(
        eng, launches, TEMPLATE_LAUNCHES[label],
        replays=bundle.fn.replays - replays0,
        verify_passes=step.aux["calls"] - verify0,
        draft_prefills=st.prefill_batches)
    got = {q.uid: q.output for q in done}
    ties = near_ties(cfg, params, reqs, plain["outputs"], got, label,
                     kv_int8=kv_dtype == "int8")
    nums = _spec_numbers(st, wall)
    partial = sum(1 for j, k in accepts if 0 < j < k)
    nums["partial_rounds"] = partial
    nums["slot_rounds"] = len(accepts) or st.spec_slot_steps
    out = {"numbers": nums, "stats": st.to_dict(), "counts": counts,
           "launches": launches, "divergences": ties,
           "tree_branches": r.tree_branches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    pn = plain["numbers"]
    log(f"  [{label}] acceptance {nums['acceptance_rate']:.3f}, "
        f"{nums['tokens_per_target_step']:.2f} tokens a target pass a slot, "
        f"{nums['verify_positions']} verify positions in "
        f"{nums['spec_rounds']} rounds, draft p50 {nums['draft_p50_ms']:.2f}"
        f" ms p95 {nums['draft_p95_ms']:.2f} ms a round, verify p50 "
        f"{nums['verify_p50_ms']:.2f} ms, branch utilization "
        f"{nums['branch_utilization']:.3f} ({nums['branch_hits']} hits), "
        f"chain slot-rounds accepting 0 < j < k: {partial}; AR "
        f"{nums['ar_tok_s']:.1f} tok/s (verify time only) vs plain "
        f"{pn['ar_tok_s']:.1f}; decode wall {nums['tokens_per_wall_s']:.1f} "
        f"tok/s (run {wall:.2f} s) vs plain {pn['tokens_per_wall_s']:.1f} "
        f"({pn['wall_s']:.2f} s); peak {out['peak_memory_gb']:.2f} GB")
    if mid_flight:
        reqs2 = _serve_requests(cfg, (120, 150, 90, 200), seed=5, uid0=40)
        for q in reqs2:
            eng.submit(q)
        for _ in range(200):
            eng.step()
            if len(r.decoding_slots()) == r.B:
                break
        else:
            raise AssertionError(f"{label}: the slots never all decoded")
        out["draft_graph_vs_eager"] = check_draft_graph_vs_eager(eng)
        # one verify pass at the slots' state: it writes KV past each
        # committed pos only, which no later pass reads before rewriting
        B, C = r.B, step.aux["num_tokens"]
        chunk = np.tile(r.tokens[:, None], (1, C)).astype(np.int32)
        clen = np.full((B,), C, np.int32)
        pos0 = r.pos.copy()
        tree = ()
        if step.fn.tree:
            from repro_torch.serving.spec import build_tree
            t = build_tree(0, [[0] * r.tree_branches] * spec.k)
            tree = (np.tile(t.depth, (B, 1)), np.tile(t.anc, (B, 1, 1)))
        one = lambda: step.fn(r.params, chunk, pos0, clen, *tree, r.caches,
                              r.block_tables, r.lane)
        out["verify_pass"] = profile_chunk_pass(cfg, one, B * C,
                                                int(pos0.max()),
                                                what="verify")
        dpos = np.array([min(ds.pos, r.max_seq - 1) if ds else 0
                         for ds in r.draft_states], np.int32)
        dstep = lambda: bundle.fn(r.tokens, dpos, None, r.lane)
        dstep()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            dstep()[0].cpu()
        d_ms = (time.perf_counter() - t1) * 1e3 / 20
        dk = device_kernels(dstep, iters=5)
        busy = sum(ms for ms, _ in dk.values()) if dk else None
        out["draft_step"] = {"wall_ms": d_ms, "device_busy_ms": busy,
                             "device_events": sum(n for _, n in dk.values())}
        log(f"  [{label}] one draft step (graph replay, host copy and "
            f"token read): wall {d_ms:.3f} ms, device busy {_ms(busy)}, "
            f"{out['draft_step']['device_events']} device events")
        eng.run()
        _check_served(eng, eng.completed[-4:], 4, 32, f"{label} mid-flight")
    del eng
    torch.cuda.empty_cache()
    return out


def plain_engine_run(label, cfg, params, *, kv_dtype=None):
    """The same trace without speculation: the outputs and numbers the
    spec runs are held to."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import InferenceEngine
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          kv_dtype=kv_dtype)
    reqs = _serve_requests(cfg)
    for q in reqs:
        eng.submit(q)
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    _check_served(eng, done, len(reqs), 32, label)
    st = eng.stats()
    nums = {"ar_tok_s": st.ar_tok_s, "ar_tokens": st.ar_tokens,
            "decode_step_p50_ms": st.decode_step_p50_ms, "wall_s": wall,
            "tokens_per_wall_s": st.ar_tokens / wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  [{label}] AR {nums['ar_tok_s']:.1f} tok/s, decode step p50 "
        f"{nums['decode_step_p50_ms']:.2f} ms, run {wall:.2f} s, peak "
        f"{nums['peak_memory_gb']:.2f} GB")
    out = {"numbers": nums, "outputs": {q.uid: q.output for q in done}}
    del eng
    torch.cuda.empty_cache()
    return out


def forced_sibling(cfg, params):
    """Tree compaction on the card: GPT-J with draft="self", k 3, width 3.
    Once every slot decodes, one round's first slot gets its depth-1
    chain token replaced by a wrong one and its draft's own token moved to
    the first sibling: the round must accept that sibling (a branch hit),
    move its KV row onto the committed position with `row_copy`, and the
    slot's next step (its decode stack at the committed pos, on clones of
    the pools) must give the logits of a teacher-forced whole-prompt
    prefill of the committed tokens, within the floor-scaled gate."""
    from repro_torch.core.embedding import embed_token
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.models import lm
    from repro_torch.serving import InferenceEngine, SpecConfig
    from repro_torch.serving import runner as runner_mod
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          spec=SpecConfig(draft="self", k=3, branches=3))
    r = eng.runner
    reqs = _serve_requests(cfg, (60, 90, 40, 120), seed=9, uid0=60)
    for q in reqs:
        q.max_new_tokens = 64
        eng.submit(q)
    for _ in range(50):
        eng.step()
        if len(r.decoding_slots()) == r.B:
            break
    else:
        raise AssertionError("forced sibling: the slots never all decoded")
    build_tree, row_copy = runner_mod.build_tree, runner_mod.row_copy
    state = {"forced": None, "copies": []}

    def forcing(pending, levels):
        # the round's first tree is the first decoding slot's
        if state["forced"] is None and levels:
            chain = levels[0][0]
            levels = [[(chain + 1) % cfg.vocab, chain] + levels[0][2:]] \
                + levels[1:]
            state["forced"] = chain
        return build_tree(pending, levels)

    def recording(caches, src_blk, src_off, dst_blk, dst_off, segments):
        state["copies"].append((src_blk, src_off, dst_blk, dst_off))
        return row_copy(caches, src_blk, src_off, dst_blk, dst_off,
                        segments)
    bs = r.layout.block_size
    runner_mod.build_tree, runner_mod.row_copy = forcing, recording
    try:
        for attempt in range(8):
            b = r.decoding_slots()[0]
            task = r.slots[b]
            n_out, pos0 = len(task.output), int(r.pos[b])
            state["forced"], state["copies"] = None, []
            eng.step()
            committed = task.output[n_out:]
            blocks = r._slot_blocks[b]
            dst = (blocks[(pos0 + 1) // bs]
                   if (pos0 + 1) // bs < len(blocks) else None,
                   (pos0 + 1) % bs)
            # the sibling was the target's choice: the round accepted it
            # and moved its row (node 2, at pos0 + 2) onto pos0 + 1
            if (len(committed) >= 2 and committed[0] == state["forced"]
                    and any(c[2:] == dst for c in state["copies"])):
                break
        else:
            raise AssertionError("forced sibling: no round accepted the "
                                 "sibling")
    finally:
        runner_mod.build_tree, runner_mod.row_copy = build_tree, row_copy
    if r.slots[b] is not task:
        raise AssertionError("forced sibling: the slot retired")
    log(f"  [forced sibling] slot {b}, attempt {attempt + 1}: chain token "
        f"{state['forced']} moved to the first sibling; the round "
        f"committed {committed} with row copies {state['copies']}")
    dev = torch.device(DEVICE)
    pools = _clone_caches(r.caches)
    with torch.no_grad():
        xd = embed_token(params["embedding"]["embed"],
                         torch.tensor(r.tokens[b:b + 1], device=dev),
                         policy=BF16)
        xd, _ = lm._run_segments_decode(
            params, xd, torch.tensor(r.pos[b:b + 1], device=dev), pools,
            cfg=cfg, policy=BF16,
            block_tables=torch.tensor(r.block_tables[b:b + 1], device=dev),
            fused=True, paged_segments=r.layout.segments)
        z_next = _head(params, cfg, xd, fused=True, policy=BF16)
    del pools
    seq = np.concatenate([np.asarray(task.prompt, np.int32),
                          np.asarray(task.output, np.int32)])
    end = [len(seq) - 1]
    if len(seq) - 1 != int(r.pos[b]):
        raise AssertionError("forced sibling: pos and committed tokens "
                             "disagree")
    z_pref = prefill_logits(cfg, params, seq, end, mode="auto", policy=BF16)
    z_ref = prefill_logits(cfg, params, seq, end, mode="ref", policy=BF16)
    z_32 = prefill_logits(cfg, params, seq, end, mode="ref", policy=FP32)
    gate = _logit_gate("forced sibling: next step after compaction vs "
                       "prefill of the committed tokens", z_next, z_pref,
                       _gap(z_ref, z_32), 2.0)
    eng.run()
    _check_served(eng, eng.completed[-4:], 4, 64, "forced sibling")
    del eng
    torch.cuda.empty_cache()
    return {"slot": b, "attempts": attempt + 1, "committed": committed,
            "row_copies": state["copies"], "gate": gate}


def phase_spec():
    """Speculative decoding at full width and depth (batch 4, max_seq 512,
    block 16, SERVE_LENGTHS, 32 new tokens, two requests sampled):
      verify   the teacher-forced verify pass (`spec_teacher_forced`) and
               `sample_topn` card vs CPU;
      engines  GPT-J draft="self" k 4; GPT-J with the mid-range draft
               (alpha SPEC_ALPHA) k 4, chain, then as a tree (k 3, width
               3); phi4-mini with its mid-range draft k 4; GPT-J with int8
               KV pools and width 3, which must fall back to the chain;
               each beside the same trace without speculation: served,
               drained, exact launches, near-tie divergences only, the
               round numbers; the draft's replay held to its eager step,
               one verify pass and one draft step profiled;
      sibling  the forced-sibling compaction (`forced_sibling`).
    Each engine is freed before the next; its peak memory is reported."""
    from repro_torch.configs import GPT_J, PHI4_MINI
    from repro_torch.models import lm
    from repro_torch.serving import SpecConfig
    t_phase = time.perf_counter()
    out = {"alpha": SPEC_ALPHA, "k": SPEC_K}
    params = lm.init_lm(GPT_J, dtype=torch.bfloat16, device=DEVICE, seed=0)
    out["teacher_forced"] = spec_teacher_forced(GPT_J, params)
    out["draft_agreement"] = draft_agreement(GPT_J, params)
    out["sample_topn"] = check_sample_topn()
    plain = plain_engine_run("gpt-j plain", GPT_J, params)
    plain8 = plain_engine_run("gpt-j plain int8 KV", GPT_J, params,
                              kv_dtype="int8")
    mid = midrange_draft(GPT_J, params)
    k_t, b_t = SPEC_TREE
    runs = {
        "gpt-j self": dict(spec=SpecConfig(draft="self", k=SPEC_K)),
        "gpt-j mid-range chain": dict(spec=SpecConfig(draft="auto",
                                                      k=SPEC_K),
                                      draft_params=mid, mid_flight=True),
        "gpt-j mid-range tree": dict(spec=SpecConfig(draft="auto", k=k_t,
                                                     branches=b_t),
                                     draft_params=mid, mid_flight=True),
        "gpt-j int8 KV tree -> chain": dict(
            spec=SpecConfig(draft="auto", k=SPEC_K, branches=b_t),
            draft_params=mid, kv_dtype="int8")}
    out["plain"] = {"gpt-j": plain["numbers"],
                    "gpt-j int8 KV": plain8["numbers"]}
    for label, kw in runs.items():
        base = plain8 if kw.get("kv_dtype") else plain
        out[label] = spec_engine_run(label, GPT_J, params, base, **kw)
    if out["gpt-j int8 KV tree -> chain"]["tree_branches"] != 1:
        raise AssertionError("int8 KV: the tree did not fall back to the "
                             "chain")
    chain, tree = out["gpt-j mid-range chain"], out["gpt-j mid-range tree"]
    out["alpha_regime"] = {
        "chain_partial_rounds": chain["numbers"]["partial_rounds"],
        "tree_branch_hits": tree["numbers"]["branch_hits"]}
    log(f"  mid-range draft alpha {SPEC_ALPHA}: chain slot-rounds with "
        f"0 < j < {SPEC_K}: {chain['numbers']['partial_rounds']}, tree "
        f"branch hits: {tree['numbers']['branch_hits']}; draft=\"self\": "
        f"{out['gpt-j self']['numbers']['partial_rounds']} slot-rounds "
        f"with 0 < j < {SPEC_K} (the forced-sibling check below holds the "
        f"compaction either way)")
    out["forced_sibling"] = forced_sibling(GPT_J, params)
    del params, mid
    torch.cuda.empty_cache()
    p4 = lm.init_lm(PHI4_MINI, dtype=torch.bfloat16, device=DEVICE, seed=1)
    plain4 = plain_engine_run("phi4-mini plain", PHI4_MINI, p4)
    out["plain"]["phi4-mini"] = plain4["numbers"]
    out["phi4-mini mid-range chain"] = spec_engine_run(
        "phi4-mini mid-range chain", PHI4_MINI, p4, plain4,
        spec=SpecConfig(draft="auto", k=SPEC_K),
        draft_params=midrange_draft(PHI4_MINI, p4))
    del p4
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"spec phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 6. the encoder-only ViT
# --------------------------------------------------------------------------

VIT_BATCH = 8


def vit_flops(cfg, B):
    """Model FLOPs of one ViT pass: 2 per weight per row (the patchify on
    the patch rows, q / k / v / o and the MLP on every row, the head on the
    cls rows) and the attention's two products, 4 S^2 H hd a layer."""
    from repro_torch.models.vit import PATCH_DIM
    E, S, H, hd = cfg.d_model, cfg.image_seq, cfg.n_heads, cfg.head_dim
    layer = 2 * S * (4 * E * H * hd + 2 * E * cfg.d_ff) + 4 * S * S * H * hd
    return B * (2 * (S - 1) * PATCH_DIM * E + cfg.n_layers * layer
                + 2 * E * cfg.n_classes)


def check_vit_counts(cfg, path, launches, fused):
    """One pass launches flash once a layer (all wgmma), the fused GEMM 4 +
    2 times a layer plus the patchify (wgmma, like the layers' GEMMs: M = B
    x 196 / 197) and the head (stream: M = B), the plain LayerNorm twice a
    layer plus the final norm when unfused and never when fused (the final
    norm folds into the head's prologue), and no other kernel."""
    L = cfg.n_layers
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention=L, fused_matmul=6 * L + 2,
                layernorm=0 if fused else 2 * L + 1)
    by = TEMPLATE_LAUNCHES[path]
    want_by = {k: dict.fromkeys(forms, 0) for k, forms in by.items()}
    want_by["fused_matmul"].update(stream=1, wgmma=6 * L + 1)
    want_by["flash_attention"].update(wgmma=L)
    if launches != want or by != want_by:
        raise AssertionError(f"{path}: launches {launches} by template {by},"
                             f" expected {want} by template {want_by}")


def vit_model(cfg, *, seed, card):
    """ViT at full width and depth, random seeded bf16 weights, a batch of
    VIT_BATCH seeded images (196 patches of 16 x 16 x 3 pixels each): the
    fused and the unfused kernel paths with exact launch counts, their
    logits held row by row to the plain (`ref`) path in bf16 (k = 2) and
    fp32 (k = 1.5) under the serve phase's floor-scaled gate (the floor:
    the worst row's gap between those two); then images/s (CUDA-event time
    of a pass, median of 20), the device's busy share of a pass and its
    largest kernels (torch.profiler)."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.kernels import ops
    from repro_torch.models import vit
    B = VIT_BATCH
    t0 = time.perf_counter()
    params = vit.init_vit(cfg, dtype=torch.bfloat16, device=DEVICE,
                          seed=seed)
    rng = np.random.default_rng(seed)
    patches = torch.tensor(rng.standard_normal(
        (B, cfg.image_seq - 1, vit.PATCH_DIM)).astype(np.float32),
        device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"vit: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}x{cfg.head_dim} d_ff {cfg.d_ff}, {n_params / 1e6:.1f} M "
        f"params, batch {B} x {cfg.image_seq} tokens, init "
        f"{time.perf_counter() - t0:.1f} s")

    def run(mode, fused, policy=BF16):
        with ops.kernel_mode(mode), torch.no_grad():
            return vit.forward_vit(params, patches, cfg=cfg, policy=policy,
                                   fused=fused)

    z_ref, z_fp32 = run("ref", True), run("ref", True, FP32)
    gaps = [_gap(z_ref[i:i + 1], z_fp32[i:i + 1]) for i in range(B)]
    floor = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    log(f"  {cfg.name} plain bf16 vs plain fp32, worst row (floor): rel "
        f"{floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
    out = {"params": n_params, "batch": B,
           "floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))},
           "launches": {}}
    flops = vit_flops(cfg, B)
    for path, fused in (("fused", True), ("unfused", False)):
        name = f"{cfg.name} vit {path}"
        need = ("flash_attention", "fused_matmul") + (
            () if fused else ("layernorm",))
        z, launches = drive(name, lambda: run("auto", fused), need)
        check_vit_counts(cfg, name, launches, fused)
        out["launches"][path] = launches
        if z.shape != (B, cfg.n_classes) or z.dtype != torch.float32:
            raise AssertionError(f"{name}: logits {tuple(z.shape)} {z.dtype}")
        for label, want, k in (("plain bf16", z_ref, 2.0),
                               ("plain fp32", z_fp32, 1.5)):
            worst = {"rel": 0.0, "cosine": 1.0}
            for i in range(B):
                g = _logit_gate(f"{name} vs {label}, image {i}", z[i:i + 1],
                                want[i:i + 1], floor, k, quiet=True)
                worst = {"rel": max(worst["rel"], g["rel"]),
                         "cosine": min(worst["cosine"], g["cosine"]),
                         "tol": g["tol"], "cos_min": g["cos_min"]}
            log(f"  {name} vs {label}, every image: worst rel "
                f"{worst['rel']:.2e} (tol {worst['tol']:.2e}), cosine "
                f"{worst['cosine']:.6f} (min {worst['cos_min']:.6f})")
            out[f"{path}_vs_{label.replace(' ', '_')}"] = worst
        fn = lambda: run("auto", fused)
        ms = time_ms(fn)
        dev = device_kernels(fn, iters=5)
        busy = sum(t for t, _ in dev.values())
        top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:6]
        gemm = sum(t for k, (t, _) in dev.items()
                   if any(g in k for g in GEMM_KERNELS))
        flash = sum(t for k, (t, _) in dev.items() if "flash" in k)
        out[path] = {
            "pass_ms": ms, "images_per_s": B / ms * 1e3,
            "model_tflops": flops / ms / 1e9,
            "device_busy_ms": busy, "busy_share": busy / ms,
            "device_events": sum(n for _, n in dev.values()),
            "gemm_ms": gemm, "flash_ms": flash,
            "device_top": [{"kernel": k, "ms": t, "launches": n}
                           for k, (t, n) in top]}
        log(f"  {name}: {B / ms * 1e3:.1f} images/s at batch {B} (pass "
            f"{ms:.3f} ms, median of 20, {flops / ms / 1e9:.1f} model "
            f"TFLOP/s; {card}); device busy {busy:.3f} ms ({busy / ms:.1%});"
            f" GEMM templates {gemm:.3f} ms, flash {flash:.3f} ms, "
            f"{out[path]['device_events']} device events")
        for k, (t, n) in top:
            log(f"    device {t:8.3f} ms  x{n:<4d} {k[:80]}")
    del params
    torch.cuda.empty_cache()
    return out


def phase_vit(card):
    """The paper's encoder-only ViT-B, ViT-L and ViT-H at full width and
    depth (`vit_model`)."""
    from repro_torch.configs import VIT_B, VIT_H, VIT_L
    return {cfg.name: vit_model(cfg, seed=seed, card=card)
            for seed, cfg in ((8, VIT_B), (9, VIT_L), (10, VIT_H))}


# --------------------------------------------------------------------------
# 7. a shallow witness for the deepest stack's logit gate
# --------------------------------------------------------------------------

def depth_witness(cfg, *, layers, seed):
    """At full depth mamba2's kernel paths sit just outside the bf16 floor
    of the plain fp32 path, where 64 random-init layers amplify any
    rounding and the gate's 5e-2 minimum is loose.  At `layers` layers, full
    width, hold every kernel path to plain fp32 within 1.5 x the floor with
    no minimum, and the fused path with the SSD kernel swapped for
    `ssd_plain` (the kernel's arithmetic in plain PyTorch, also fp32 inside)
    within 1 x the floor of the kernel path: what the SSD kernel itself adds
    to the gap."""
    import dataclasses

    from repro_torch.core.precision import FP32
    from repro_torch.kernels import ssd as sd
    from repro_torch.models import lm

    if cfg.schedule != (("ssm", cfg.n_layers),):
        raise ValueError(f"{cfg.name}: the witness cuts a pure ssm stack")
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              schedule=(("ssm", layers),))
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 96),
                                       dtype=np.int32), device=DEVICE)
    name = f"{cfg.name} at {layers} layers"
    z_ref = teacher_forced(cfg, params, prompt, mode="ref", fused=True)
    z_fp32 = teacher_forced(cfg, params, prompt, mode="ref", fused=True,
                            policy=FP32)
    floor = _gap(z_ref, z_fp32)
    log(f"witness: {name}, teacher-forced plain bf16 vs plain fp32 (floor): "
        f"rel {floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
    out = {"layers": layers,
           "floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))}}
    z = {}
    for path, fused in (("fused", True), ("unfused", False)):
        sd.ssd.launches = 0
        z[path] = teacher_forced(cfg, params, prompt, mode="auto",
                                 fused=fused)
        if sd.ssd.launches != layers:
            raise AssertionError(f"{name} {path}: ssd launched "
                                 f"{sd.ssd.launches} times, not {layers}")
        out[f"{path}_vs_plain_fp32"] = _logit_gate(
            f"{name} {path} kernel path vs plain fp32", z[path], z_fp32,
            floor, 1.5, minimum=False)
    kernel = sd.ssd
    sd.ssd = lambda *args: sd.ssd_plain(*args)
    try:
        z_swap = teacher_forced(cfg, params, prompt, mode="auto", fused=True)
    finally:
        sd.ssd = kernel
    out["ssd_plain_swap_vs_plain_fp32"] = _logit_gate(
        f"{name} fused path, SSD kernel swapped for ssd_plain, vs plain fp32",
        z_swap, z_fp32, floor, 1.5, minimum=False)
    out["fused_vs_ssd_plain_swap"] = _logit_gate(
        f"{name} fused kernel path vs the same with ssd_plain", z["fused"],
        z_swap, floor, 1.0, minimum=False)
    del params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 8. the ring witness: decode across the ring's wrap, held to prefill
# --------------------------------------------------------------------------

def decode_logits(cfg, params, tokens, prompt_len, *, mode, fused, policy,
                  max_seq, block_size=16, kv_dtype=None, frames=None):
    """Teacher-forced decode logits [steps, vocab] fp32 of one sequence:
    `tokens[:prompt_len]` prefilled into the engine's decode caches
    (`cache_layout` / `prefill_scatter`, paged global layers, ring local
    ones; `kv_dtype="int8"`: int8 pools quantized on write; an
    encoder-decoder's encoder over `frames` first, its cross caches into
    the slot's rows), then one step per remaining token through the decode
    stack that `forward_decode` runs (with its embedding step), and the
    logits head."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import cache_layout, make_paged_layout
    from repro_torch.models import lm
    from repro_torch.serving.kv_cache import prefill_scatter
    dev = torch.device(DEVICE)
    layout = make_paged_layout(cfg, max_seq, -(-max_seq // block_size),
                               block_size)
    table = torch.arange(layout.max_blocks, dtype=torch.int32,
                         device=dev)[None]
    tok = torch.tensor(tokens, device=dev)
    out = []
    with ops.kernel_mode(mode), torch.no_grad():
        caches = cache_layout(cfg, layout, batch_size=1, policy=policy,
                              device=dev, kv_dtype=kv_dtype)
        memory = lm._memory(params, frames, cfg=cfg, policy=policy,
                            fused=fused)
        x = lm._embed_sequence(params, tok[None, :prompt_len], cfg=cfg,
                               policy=policy)
        _, group = lm._run_segments_prefill(
            params, x, cfg=cfg, policy=policy, max_seq=max_seq, fused=fused,
            compact_kv=True, memory=memory)
        prefill_scatter(caches, group, torch.zeros(1, dtype=torch.int64,
                                                   device=dev), table,
                        block_size=block_size,
                        paged_segments=layout.segments)
        del group
        for pos in range(prompt_len, len(tokens)):
            xd = lm._embed_step(params, tok[pos:pos + 1],
                                torch.tensor([pos], device=dev), cfg=cfg,
                                policy=policy)
            xd, _ = lm._run_segments_decode(
                params, xd, torch.tensor([pos], device=dev), caches, cfg=cfg,
                policy=policy, block_tables=table, fused=fused,
                paged_segments=layout.segments)
            out.append(_head(params, cfg, xd, fused=fused, policy=policy))
    return torch.cat(out)


# the noise-floor rule for greedy flips (the reference's quant benchmark):
# the int8 logits move by less than 1% of their span, and the argmax flips
# of int8 against bf16 are none, or under 1% of the positions, or at most
# 2x + 2 those of the control (bf16 weights perturbed by uniform noise of
# half a quantization step: an unbiased perturbation of int8's size).  At
# full depth with random weights and bf16 compute the logits move by more
# than 1% of their span under any perturbation (plain bf16 is 1-5% of
# max|z| from plain fp32 here), so the span bound is the larger of 1% and
# twice the control's own max|dz|; the strict 1% verdict is reported too.
FLIP_LOGIT_SPAN = 0.01
FLIP_FRAC = 0.01


def noise_params(params, qparams, seed):
    """The noise-floor control: `params` with every weight that int8
    serving quantizes perturbed by independent uniform noise of +- half
    its column's quantization step (scale / 2), in fp32, cast back."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def walk(p, q):
        if isinstance(q, dict) and set(q) == {"q", "scale"}:
            amp = 0.5 * q["scale"].unsqueeze(-2)
            u = torch.rand(p.shape, generator=g, device=p.device) * 2 - 1
            return (p.float() + u * amp).to(p.dtype)
        if isinstance(p, dict):
            return {k: walk(p[k], q[k]) for k in p}
        if isinstance(p, tuple):
            return tuple(walk(a, b) for a, b in zip(p, q))
        return p
    return walk(params, qparams)


def flip_rule(z, z16, zn):
    """The noise-floor rule on teacher-forced logits [steps, vocab]: `z`
    (int8) and `zn` (the control) against `z16` (bf16)."""
    c16 = z16.argmax(-1)
    flips = int((z.argmax(-1) != c16).sum())
    noise_flips = int((zn.argmax(-1) != c16).sum())
    span = float(z16.max() - z16.min())
    err = float((z - z16).abs().max())
    noise_err = float((zn - z16).abs().max())
    bound = max(FLIP_LOGIT_SPAN * span, 2 * noise_err)
    flips_ok = (flips == 0 or flips / len(z) < FLIP_FRAC
                or flips <= 2 * noise_flips + 2)
    return {"flips": flips, "noise_flips": noise_flips, "steps": len(z),
            "logit_err": err, "noise_logit_err": noise_err,
            "logit_span": span, "logit_bound": bound,
            "strict_span_ok": err < FLIP_LOGIT_SPAN * span,
            "ok": err < bound and flips_ok}


def int8_decode_checks(cfg, params, qparams, *, seed, kv_dtype,
                       prompt_len=64, steps=48, gated_steps=8,
                       max_seq=512, frames=None):
    """Teacher-forced decode of one sequence (a `prompt_len`-token prompt,
    then `steps` forced tokens) through the engine's int8 configuration
    (`qparams`, int8 KV with `kv_dtype="int8"`):
    (a) the int8 kernel path's logits at the first `gated_steps` steps
        held to the int8 plain path (`ref` mode, the same quantized
        weights and KV layout) under the floor-scaled gate (k = 2), the
        floor being plain int8 bf16 vs plain int8 fp32 over those steps;
    (b) greedy flips of int8 weights (bf16 KV, as the reference's rule
        counts them) against bf16 weights at every step, beside the
        noise-floor control's, under the rule above (`flip_rule`); the
        flips of the served configuration (int8 weights and KV) are
        counted beside them, against the same control.
    An encoder-decoder's sequence runs behind `frames` (its encoder on
    each path's weights)."""
    from repro_torch.core.precision import BF16, FP32
    rng = np.random.default_rng(seed + 50)
    tokens = rng.integers(0, cfg.vocab, prompt_len + steps, dtype=np.int32)
    short = tokens[:prompt_len + gated_steps]
    kw = dict(max_seq=max_seq, fused=True, frames=frames)
    name = f"{cfg.name} int8 decode, prompt {prompt_len}"
    z_ref = decode_logits(cfg, qparams, short, prompt_len, mode="ref",
                          policy=BF16, kv_dtype=kv_dtype, **kw)
    z_fp32 = decode_logits(cfg, qparams, short, prompt_len, mode="ref",
                           policy=FP32, kv_dtype=kv_dtype, **kw)
    gaps = [_gap(z_ref[i:i + 1], z_fp32[i:i + 1]) for i in range(gated_steps)]
    floor = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    z8, launches = drive(
        f"{name} kernel path",
        lambda: decode_logits(cfg, qparams, tokens, prompt_len, mode="auto",
                              policy=BF16, kv_dtype=kv_dtype, **kw),
        ("fused_matmul", "paged_decode_attention", "flash_attention"))
    worst = {"rel": 0.0, "cosine": 1.0}
    for i in range(gated_steps):
        g = _logit_gate(f"{name} kernel vs plain at step {i}", z8[i:i + 1],
                        z_ref[i:i + 1], floor, 2.0, quiet=True)
        worst = {"rel": max(worst["rel"], g["rel"]),
                 "cosine": min(worst["cosine"], g["cosine"]),
                 "tol": g["tol"], "cos_min": g["cos_min"]}
    log(f"  {name}: int8 kernel path vs int8 plain path over {gated_steps} "
        f"steps: worst rel {worst['rel']:.2e} (tol {worst['tol']:.2e}), "
        f"cosine {worst['cosine']:.6f} (min {worst['cos_min']:.6f}); floor "
        f"rel {floor[0]:.2e}")
    z16 = decode_logits(cfg, params, tokens, prompt_len, mode="auto",
                        policy=BF16, **kw)
    z8w = decode_logits(cfg, qparams, tokens, prompt_len, mode="auto",
                        policy=BF16, **kw)
    noisy = noise_params(params, qparams, seed + 17)
    zn = decode_logits(cfg, noisy, tokens, prompt_len, mode="auto",
                       policy=BF16, **kw)
    del noisy
    top2 = torch.topk(z16, 2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).median())
    rules = {"int8 weights": flip_rule(z8w, z16, zn),
             "int8 weights + KV": flip_rule(z8, z16, zn)}
    for label, r in rules.items():
        log(f"  {name}: {label}: greedy flips vs bf16 {r['flips']}/{steps}, "
            f"noise-floor control {r['noise_flips']}/{steps}; max |dz| "
            f"{r['logit_err']:.4f} (control {r['noise_logit_err']:.4f}, "
            f"bound {r['logit_bound']:.4f}) of span {r['logit_span']:.2f} "
            f"(under 1% of it: {r['strict_span_ok']}), median top-2 margin "
            f"{margin:.4f}: {'pass' if r['ok'] else 'FAIL'}")
    if not rules["int8 weights"]["ok"]:
        raise AssertionError(f"{name}: int8 weights fail the noise-floor "
                             f"rule: {rules['int8 weights']}")
    return {"vs_plain": worst, "floor": {"rel": floor[0],
                                         "cosine": float(np.cos(floor[1]))},
            "launches": launches, "median_margin": margin, "flips": rules}


def ring_witness(cfg, *, seed, prompt_len=1000, steps=40, max_seq=2048,
                 exact_at=(1010, 1023, 1024, 1039)):
    """gemma3 at full width cut to one period (5 local layers, 1 global) at
    max_seq 2048: a `prompt_len` prompt, then `steps` teacher-forced decode
    steps across position 1024, where each local layer's 1024-slot ring
    wraps in place.
    (a) the fused and unfused kernel paths' logits at every step held to
        plain bf16 (k = 2) and plain fp32 (k = 1.5) under the serve phase's
        floor-scaled gate, the floor (plain bf16 vs plain fp32) taken as its
        largest value over the same steps;
    (b) plain fp32 decode (fp32 KV caches) at `exact_at` positions within
        1e-4 of max|z| of the final-position logits of an exact-length
        prefill of the same tokens: the ring's semantics held to the
        windowed flash-attention mask."""
    import dataclasses

    from repro_torch.core.precision import BF16, FP32
    from repro_torch.models import lm

    cfg = dataclasses.replace(cfg, n_layers=6,
                              schedule=(("local", 5), ("attn", 1)))
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, prompt_len + steps, dtype=np.int32)
    name = f"{cfg.name} one period, prompt {prompt_len} + {steps} steps"
    kw = dict(max_seq=max_seq)
    z_ref = decode_logits(cfg, params, tokens, prompt_len, mode="ref",
                          fused=True, policy=BF16, **kw)
    z_fp32 = decode_logits(cfg, params, tokens, prompt_len, mode="ref",
                           fused=True, policy=FP32, **kw)
    gaps = [_gap(z_ref[i:i + 1], z_fp32[i:i + 1]) for i in range(steps)]
    floor = (max(g[0] for g in gaps), max(g[1] for g in gaps))
    log(f"witness: {name}, plain bf16 vs plain fp32 over the {steps} steps "
        f"(floor): rel {floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
    out = {"floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))}}
    ring = ring_layers(cfg, max_seq)
    for path, fused in (("fused", True), ("unfused", False)):
        z, launches = drive(
            f"{name} {path}",
            lambda: decode_logits(cfg, params, tokens, prompt_len,
                                  mode="auto", fused=fused, policy=BF16,
                                  **kw),
            ("decode_attention", "paged_decode_attention",
             "flash_attention"))
        if launches["decode_attention"] != ring * steps:
            raise AssertionError(f"{name} {path}: decode_attention launched "
                                 f"{launches['decode_attention']} times, not "
                                 f"{ring * steps}")
        for label, want, k in (("plain bf16", z_ref, 2.0),
                               ("plain fp32", z_fp32, 1.5)):
            worst = {"rel": 0.0, "cosine": 1.0}
            for i in range(steps):
                g = _logit_gate(f"{name} {path} vs {label} at position "
                                f"{prompt_len + i}", z[i:i + 1],
                                want[i:i + 1], floor, k, minimum=False,
                                quiet=True)
                worst = {"rel": max(worst["rel"], g["rel"]),
                         "cosine": min(worst["cosine"], g["cosine"]),
                         "tol": g["tol"], "cos_min": g["cos_min"]}
            log(f"  {path} kernel path vs {label}, every step: worst rel "
                f"{worst['rel']:.2e} (tol {worst['tol']:.2e}), cosine "
                f"{worst['cosine']:.6f} (min {worst['cos_min']:.6f})")
            out[f"{path}_vs_{label.replace(' ', '_')}"] = worst
    exact = {}
    for p in exact_at:
        zp = teacher_forced(cfg, params, torch.tensor(tokens[None, :p + 1],
                                                      device=DEVICE),
                            mode="ref", fused=True, policy=FP32, **kw)
        rel = _gap(z_fp32[p - prompt_len:p - prompt_len + 1], zp)[0]
        exact[p] = rel
        log(f"  plain fp32 decode at position {p} vs exact-length prefill: "
            f"max|dz| / max|z| {rel:.2e} (tol {RING_EXACT_TOL:.0e})")
        if not rel <= RING_EXACT_TOL:
            raise AssertionError(f"{name}: ring decode at position {p} "
                                 f"differs from prefill by {rel}")
    out["decode_vs_prefill_fp32"] = exact
    del params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# 9. the MoE family: mixtral-8x7b at full width
# --------------------------------------------------------------------------

# mixtral-8x7b holds 2.90 GB a layer in bf16 (experts 2.82, attention
# 0.084) and 0.52 GB of embedding and head: 93.4 GB at its 32 layers, past
# the 80 GB card.  Served at full width cut to 16 layers (46.9 GB); the
# teacher-forced gates run on a 4-layer witness (12.1 GB in bf16).
MOE_SERVE_LAYERS = 16
MOE_WITNESS_LAYERS = 4
PREFIX_RUN_REQUESTS = 4


def moe_cut(layers, **kw):
    """mixtral-8x7b at full width cut to `layers` `moe_local` layers."""
    import dataclasses

    from repro_torch.configs import MIXTRAL_8X7B
    return dataclasses.replace(MIXTRAL_8X7B, n_layers=layers,
                               schedule=(("moe_local", layers),), **kw)


def prefix_chunk_run(cfg, params):
    """PREFIX_RUN_REQUESTS requests sharing a PREFIX_LEN-token prefix (the
    first served to its first token before the rest arrive) under
    ChunkedPrefillPolicy(CHUNK) with the prefix cache: every prompt chunks
    through `block_chunk` (no whole-prompt pass, so no flash launch), the
    warm ones from their cached prefix; served, exact counts (an MoE
    config's expert form by each chunk pass's capacity), the cache hit,
    the index clean, no leak after clear()."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import ChunkedPrefillPolicy, InferenceEngine
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          scheduler=ChunkedPrefillPolicy(CHUNK),
                          prefix_cache=True)
    rows = track_prefill_rows(eng)
    reqs = _prefix_requests(cfg)[:PREFIX_RUN_REQUESTS]

    def run():
        eng.submit(reqs[0])
        while not reqs[0].output:
            eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        return list(eng.completed)
    label = f"{cfg.name} chunked prefix serve"
    need = tuple(k for k in path_kernels(cfg, "serve")
                 if k != "flash_attention") + ("paged_chunk_partials",)
    done, launches = drive(label, run, need)
    st = eng.stats()
    by = TEMPLATE_LAUNCHES[label]
    _check_served(eng, done, len(reqs), 24, label)
    check_serve_counts(cfg, launches, st, 512, by=by)
    check_gemm_templates(cfg, st, by, chunks=chunk_passes(eng),
                         prefill_rows=list(rows))
    eng.prefix_cache.check()
    if not (st.prefill_chunks > 0 and st.prefix_cache_hit_rate > 0
            and st.cached_prefix_tokens >= (len(reqs) - 1) * 192):
        raise AssertionError(f"{label}: {st.prefill_chunks} chunk passes, "
                             f"hit rate {st.prefix_cache_hit_rate}, "
                             f"{st.cached_prefix_tokens} cached tokens")
    eng.prefix_cache.clear()
    if eng.allocator.num_free != eng.allocator.num_blocks:
        raise AssertionError(f"{label}: blocks leaked after clear()")
    nums = _serve_numbers(st)
    _log_numbers(label, nums)
    log(f"  [{label}] hit rate {st.prefix_cache_hit_rate:.3f}, "
        f"{st.cached_prefix_tokens} cached prompt tokens, chunk passes by "
        f"width {chunk_passes(eng)}; index clean; no leak after clear()")
    out = {"numbers": nums, "stats": st.to_dict(), "launches": launches,
           "chunk_passes": chunk_passes(eng)}
    del eng
    torch.cuda.empty_cache()
    return out


def chain_spec_run(cfg, params, draft):
    """Chain speculation (k SPEC_K) with the registered `draft` (a dense
    2-layer SwiGLU draft at the target's widths, seeded weights) over the
    first 4 requests of the serve trace.  The spec gate refuses any
    window (the reference's rule), so the target runs with its window off:
    at max_seq 512 mixtral's 4096 window never binds, the same function.
    Served and drained, the draft's step captured, exact launches (an MoE
    target's verify passes' expert form at their B x (k + 1) rows); each
    request's first token (its prefill's) equal to the plain run's.  A
    dense target's first divergence from the plain run must be a near tie
    (`near_ties`).  An MoE target's later tokens are reported, not gated:
    an MoE layer's capacity follows the rows a pass routes (2 an expert at
    a decode step of 4, 7 at a verify pass of 20), so where a pair drops
    in one and not the other the tokens differ by design, in the
    reference too."""
    import dataclasses

    from repro_torch.core.precision import BF16
    from repro_torch.serving import InferenceEngine, SpecConfig
    scfg = dataclasses.replace(cfg, sliding_window=0)
    lengths = SERVE_LENGTHS[:4]
    engine = lambda **kw: InferenceEngine(
        scfg, params, batch_size=4, max_seq=512, block_size=16, policy=BF16,
        device=DEVICE, **kw)
    eng = engine()
    for q in _serve_requests(scfg, lengths):
        eng.submit(q)
    plain = {q.uid: q.output for q in eng.run()}
    del eng
    eng = engine(spec=SpecConfig(draft=draft, k=SPEC_K))
    r = eng.runner
    rows = track_prefill_rows(eng)
    bundle = r.draft_decode_step
    if not bundle.aux["captured"]:
        raise AssertionError(f"{cfg.name} spec: the draft step is not "
                             f"captured")
    reqs = _serve_requests(scfg, lengths)
    for q in reqs:
        eng.submit(q)
    label = f"{cfg.name} spec"
    replays0, verify0 = bundle.fn.replays, r.verify_step.aux["calls"]
    t0 = time.perf_counter()
    moe = ("expert_swiglu", "residual_rmsnorm") if moe_layers(cfg) else (
        "fused_matmul_swiglu",)
    done, launches = drive(label, eng.run,
                           ("fused_matmul", "flash_attention",
                            "decode_attention", "paged_chunk_partials")
                           + moe)
    wall = time.perf_counter() - t0
    st = eng.stats()
    _check_served(eng, done, len(reqs), 32, label)
    counts = check_spec_counts(
        eng, launches, TEMPLATE_LAUNCHES[label],
        replays=bundle.fn.replays - replays0,
        verify_passes=r.verify_step.aux["calls"] - verify0,
        draft_prefills=st.prefill_batches, prefill_rows=list(rows))
    got = {q.uid: q.output for q in done}
    first = [u for u in got if got[u][0] != plain[u][0]]
    if first:
        raise AssertionError(f"{label}: first tokens differ from the plain "
                             f"run's for requests {first}")
    same = sum(got[u] == plain[u] for u in got)
    ties = [] if moe_layers(cfg) else near_ties(scfg, params, reqs, plain,
                                                got, label)
    nums = _spec_numbers(st, wall)
    log(f"  [{label}] acceptance {nums['acceptance_rate']:.3f}, "
        f"{nums['tokens_per_target_step']:.2f} tokens a target pass a slot, "
        f"{nums['verify_positions']} verify positions in "
        f"{nums['spec_rounds']} rounds, draft p50 {nums['draft_p50_ms']:.2f}"
        f" ms a round, verify p50 {nums['verify_p50_ms']:.2f} ms; "
        f"{same} of {len(got)} requests token-identical to plain decode, "
        f"every first token equal")
    out = {"numbers": nums, "stats": st.to_dict(), "counts": counts,
           "launches": launches, "identical_to_plain": same,
           "divergences": ties,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng
    torch.cuda.empty_cache()
    return out


def moe_witness(*, layers, seed):
    """mixtral-8x7b at full width cut to `layers` layers, one 96-token
    prompt teacher-forced through the plain bf16 and fp32 paths and the
    fused and unfused kernel paths.  Routing is discontinuous: a token
    whose top-2 differs between two paths swaps a whole FFN, so paths run
    freely differ by far more than rounding (their gaps are reported, not
    gated).  So every path also runs with its routing pinned to the plain
    bf16 path's choices (each layer's experts; the weights from its own
    router's probabilities), and there: the kernel paths' final-position
    logits are held to plain bf16 (k = 2) and plain fp32 (k = 1.5) by the
    floor-scaled gate, the floor being the pinned plain paths' gap; and at
    every layer the experts each kernel path's own router would choose are
    compared with plain bf16's for every token: each disagreement must be
    a near tie, the plain bf16 probabilities of the swapped experts within
    NEAR_TIE_K router floors of each other (that layer's largest |p_bf16 -
    p_fp32| under the pin: what rounding alone moves the router by)."""
    from repro_torch.core import mlp
    from repro_torch.core.precision import FP32
    from repro_torch.models import lm
    cfg = moe_cut(layers)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    rng = np.random.default_rng(2)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 96),
                                       dtype=np.int32), device=DEVICE)
    route = mlp._route

    def routed(fn, pin=None):
        """fn() with every layer's router recorded (its probabilities and
        its own top-k) and, with `pin`, the top-k replaced by pin's."""
        rec = []

        def spy(xc, wr, *, cfg, policy):
            probs, w, i = route(xc, wr, cfg=cfg, policy=policy)
            rec.append((probs.float(), i))
            if pin is not None:
                i = pin[len(rec) - 1][1]
                w = probs.gather(1, i)
                w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, w, i
        mlp._route = spy
        try:
            z = fn()
        finally:
            mlp._route = route
        if len(rec) != layers:
            raise AssertionError(f"moe witness: {len(rec)} routings, not "
                                 f"{layers}")
        return z, rec

    run = lambda mode, fused=True, policy=None: lambda: teacher_forced(
        cfg, params, prompt, mode=mode, fused=fused, policy=policy)
    name = f"{cfg.name} at {layers} layers"
    z_ref, r_ref = routed(run("ref"))
    z_fp32_free, r_fp32_free = routed(run("ref", policy=FP32))
    free = {"plain_fp32": {"gap": _gap(z_fp32_free, z_ref),
                           "flips": _route_flips(r_fp32_free, r_ref)}}
    for path, fused in (("fused", True), ("unfused", False)):
        z, rec = routed(run("auto", fused))
        free[path] = {"gap": _gap(z, z_ref), "flips": _route_flips(rec,
                                                                 r_ref)}
    log(f"moe witness: {name}, run freely against plain bf16 (not gated): "
        + "; ".join(f"{k} rel {v['gap'][0]:.2e} cosine "
                    f"{np.cos(v['gap'][1]):.6f}, {v['flips']} (token, "
                    f"layer) routing disagreements" for k, v in free.items()))
    z_fp32, r_fp32 = routed(run("ref", policy=FP32), pin=r_ref)
    floor = _gap(z_ref, z_fp32)
    rfloor = [float((a[0] - b[0]).abs().max()) for a, b in zip(r_ref, r_fp32)]
    log(f"  [{name}] routing pinned to plain bf16's: plain bf16 vs plain "
        f"fp32 (floor) rel {floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}; "
        f"router floors by layer {[f'{f:.2e}' for f in rfloor]}, plain "
        f"fp32's own choices differing at {_route_flips(r_fp32, r_ref)} "
        f"(token, layer)")
    out = {"layers": layers, "free_running": free,
           "floor": {"rel": floor[0], "cosine": float(np.cos(floor[1]))},
           "router_floor": rfloor,
           "plain_fp32_routing": _routing_gate(f"{name} plain fp32", r_fp32,
                                               r_ref, rfloor)}
    for path, fused in (("fused", True), ("unfused", False)):
        (z, rec), out[f"launches_{path}"] = drive(
            f"{name} teacher-forced {path}",
            lambda: routed(run("auto", fused), pin=r_ref),
            path_kernels(cfg, path))
        out[f"{path}_vs_plain_bf16"] = _logit_gate(
            f"{name} {path} kernel path vs plain bf16", z, z_ref, floor, 2.0)
        out[f"{path}_vs_plain_fp32"] = _logit_gate(
            f"{name} {path} kernel path vs plain fp32", z, z_fp32, floor, 1.5)
        out[f"{path}_routing"] = _routing_gate(f"{name} {path}", rec, r_ref,
                                               rfloor)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  [{name}] peak memory {out['peak_memory_gb']:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return out


def _route_flips(rec, ref):
    """(token, layer) pairs whose chosen expert sets differ."""
    return sum(int((torch.sort(a[1], -1).values
                    != torch.sort(b[1], -1).values).any(-1).sum())
               for a, b in zip(rec, ref))


def _routing_gate(label, rec, ref, rfloor):
    """Every (token, layer) whose own top-k set differs from the plain
    bf16 path's: the margin (the largest gap, in the plain bf16 path's
    probabilities, between an expert only one side chose and one only the
    other chose) within NEAR_TIE_K x that layer's router floor."""
    rows = []
    for layer, ((_, i_k), (p_r, i_r)) in enumerate(zip(rec, ref)):
        for t in range(i_r.shape[0]):
            a, b = set(i_k[t].tolist()), set(i_r[t].tolist())
            if a == b:
                continue
            margin = max(abs(float(p_r[t, e]) - float(p_r[t, f]))
                         for e in a - b for f in b - a)
            rows.append({"token": t, "layer": layer, "own": sorted(a),
                         "plain": sorted(b), "margin": margin,
                         "floor": rfloor[layer],
                         "near_tie": margin <= NEAR_TIE_K * rfloor[layer]})
    log(f"  [{label}] routing vs plain bf16 (pinned): {len(rows)} (token, "
        f"layer) disagreements, largest margin / floor "
        f"{max((r['margin'] / r['floor'] for r in rows), default=0.0):.2f}"
        f" (near tie <= {NEAR_TIE_K})")
    bad = [r for r in rows if not r["near_tie"]]
    if bad:
        raise AssertionError(f"{label}: routing disagreements that are no "
                             f"near tie: {bad}")
    return {"disagreements": len(rows), "rows": rows}


def phase_moe():
    """mixtral-8x7b at full width (E 4096, 8 experts x F 14336, top-2, GQA
    32 / 8) cut to MOE_SERVE_LAYERS layers, seeded bf16 weights: the serve
    trace through the fused engine (`serve_model`: exact launches, the
    expert form by each pass's capacity, the graph replay bit-equal to the
    eager step, the decode profiles with the expert form's and the expert
    down-projection's (cuBLAS bmm) share), the chunked prefix run and the
    chain speculation run on the same weights; then, the 16 layers freed,
    the MOE_WITNESS_LAYERS-layer witness."""
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = moe_cut(MOE_SERVE_LAYERS)
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=8)
    out = {"layers": MOE_SERVE_LAYERS,
           "serve": serve_model(cfg, seed=8, params=params, teacher=False),
           "chunk_prefix": prefix_chunk_run(cfg, params),
           "spec": chain_spec_run(cfg, params, "mixtral-8x7b-draft")}
    del params
    torch.cuda.empty_cache()
    out["witness"] = moe_witness(layers=MOE_WITNESS_LAYERS, seed=9)
    out["seconds"] = time.perf_counter() - t0
    log(f"moe phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 10. the remaining dense decoders
# --------------------------------------------------------------------------

# chatglm3-6b holds 12.5 GB of bf16 at its 28 layers: served whole.
# deepseek-67b holds 1.384 GB a layer (692.1 M params) and 3.36 GB of
# embedding and head (`ModelConfig.n_params`): 134.9 GB at its 95 layers,
# past the 80 GB card; served at full width cut to 30 layers (30 x 1.384 +
# 3.36 = 44.9 GB).  internvl2-76b: 1.711 GB a layer (855.7 M) and 4.20 GB,
# 141.1 GB at 80 layers; cut to 24 (24 x 1.711 + 4.20 = 45.3 GB) and served
# at max_seq 1024, where its 256-position patch prefix leaves 767 prompt
# positions (255 at max_seq 512).
DEEPSEEK_LAYERS = 30
INTERNVL2_LAYERS = 24
VLM_MAX_SEQ = 1024
GLM_TAG = "chatglm3-6b"        # every drive label of a chatglm3 path


def dense_cut(cfg, layers):
    """`cfg` at full width cut to `layers` `attn` layers."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=layers,
                               schedule=(("attn", layers),))


def phase_dense():
    """The remaining dense decoders at full width, seeded bf16 weights,
    each freed before the next is made: chatglm3-6b whole (GQA 32 / 2: the
    paged decode's G = 16 form once a layer a decode step inside the
    captured graph) through `serve_model` (exact launches, the replay
    bit-equal to the eager step, no leak, the teacher-forced gates), the
    shared-prefix trace chunked with the prefix cache (the chunk stack at
    G = 16) and chain speculation (k 4) with `chatglm3-6b-draft` (the
    dense decode's G = 16 form in the draft's graph); deepseek-67b cut to
    DEEPSEEK_LAYERS layers through `serve_model`; internvl2-76b cut to
    INTERNVL2_LAYERS layers at max_seq VLM_MAX_SEQ, its prompts behind
    zero patch rows (`check_patch_prefix`), its teacher-forced prompt
    behind seeded ones."""
    from repro_torch.configs import CHATGLM3_6B, DEEPSEEK_67B, INTERNVL2_76B
    from repro_torch.models import lm
    t0 = time.perf_counter()
    glm = CHATGLM3_6B
    params = lm.init_lm(glm, dtype=torch.bfloat16, device=DEVICE, seed=10)
    out = {glm.name: {
        "layers": glm.n_layers,
        "serve": serve_model(glm, seed=10, params=params),
        "chunk_prefix": prefix_chunk_run(glm, params),
        "spec": chain_spec_run(glm, params, "chatglm3-6b-draft")}}
    del params
    torch.cuda.empty_cache()
    for cfg, kw in ((dense_cut(DEEPSEEK_67B, DEEPSEEK_LAYERS), {"seed": 11}),
                    (dense_cut(INTERNVL2_76B, INTERNVL2_LAYERS),
                     {"seed": 12, "max_seq": VLM_MAX_SEQ})):
        out[cfg.name] = {"layers": cfg.n_layers,
                         "serve": serve_model(cfg, **kw)}
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"dense phase: {out['seconds']:.1f} s")
    return out


WHISPER_SEED = 13


def check_whisper_refusals(cfg, params):
    """An encoder-decoder's cross-attention memory is not paged: an engine
    asked for the prefix cache and the chunked policy gets neither, with
    the reference's reason, and serves whole prompts; speculation is
    refused with the reference's reason before any draft is made."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import (InferenceEngine, Request, SpecConfig,
                                     make_policy)
    from repro_torch.serving.spec import spec_support_reason
    cross = "cross-attention memory is not paged"
    spec = "encoder-decoder cross-attention memory is not paged"
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          prefix_cache=True,
                          scheduler=make_policy("chunked", chunk_tokens=CHUNK,
                                                cache_aware=True))
    r = eng.runner
    got = {"chunk": r.chunk_unsupported_reason,
           "prefix_cache": r.prefix_cache_reason,
           "spec": spec_support_reason(cfg)}
    if (got != {"chunk": cross, "prefix_cache": cross, "spec": spec}
            or r.supports_chunked or eng.prefix_cache is not None):
        raise AssertionError(f"{cfg.name}: refusals {got}")
    rng = np.random.default_rng(3)
    for uid, n in enumerate((300, 40)):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, n,
                                                        dtype=np.int32),
                           max_new_tokens=4))
    done = eng.run()
    st = eng.stats()
    if (len(done) != 2 or st.prefill_chunks != 0
            or eng.allocator.num_free != eng.allocator.num_blocks):
        raise AssertionError(f"{cfg.name}: the chunked policy served "
                             f"{len(done)} requests, {st.prefill_chunks} "
                             f"chunk passes")
    del eng
    try:
        InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                        policy=BF16, device=DEVICE,
                        spec=SpecConfig(draft="self", k=4))
    except ValueError as e:
        if spec not in str(e):
            raise
        got["spec_engine"] = str(e)
    else:
        raise AssertionError(f"{cfg.name}: a speculative engine was built")
    log(f"  [{cfg.name}] refused in the reference's words: chunked prefill "
        f"and the prefix cache ({cross}; the chunked policy served 2 "
        f"requests whole), speculation ({got['spec_engine']})")
    return got


def phase_whisper():
    """whisper-base at full size (6 encoder + 6 decoder layers, d_model
    512, vocab 51865: 0.19 GB of bf16), seeded weights, behind
    InferenceEngine(batch_size=4, max_seq=512, block_size=16): the serve
    trace with SERVE_ENCODES mixed in through the fused engine, every
    prefill and encode pass running the encoder over zero frames (4 x
    1504 rows at batch 4), with `serve_model`'s gates: exact launches
    (a full pass 96 wgmma GEMMs, 18 flash calls: 6 encoder, 6 causal, 6
    cross, and the encoder's final LayerNorm; a decode step 49 stream
    GEMMs, 6 paged decodes and 6 dense decodes of the cross step, all
    in the captured graph), the replay bit-equal to the eager step, no
    leak, the teacher-forced logits behind seeded frames held to plain
    bf16 / fp32, the encodes to the plain path; a prefill profile with
    the encoder's share; the same trace through the unfused engine; int8
    weights and int8 KV (int8 forms only; `int8_decode_checks`); the
    refusals (`check_whisper_refusals`)."""
    from repro_torch.configs import WHISPER_BASE
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import lm
    t0 = time.perf_counter()
    cfg = WHISPER_BASE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = fd.dense_splits(4, cfg.n_kv_heads, cfg.enc_seq_padded, sms)
    log(f"whisper: the cross step's dense decode at B 4, KV "
        f"{cfg.n_kv_heads}, S {cfg.enc_seq_padded}: {splits} splits of "
        f"{fd.dense_range(cfg.enc_seq_padded, splits)} positions")
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE,
                        seed=WHISPER_SEED)
    out = {"dense_splits": splits,
           "fused": serve_model(cfg, seed=WHISPER_SEED, params=params,
                                encodes=SERVE_ENCODES, prefill_profile=True),
           "unfused": serve_model(cfg, seed=WHISPER_SEED, params=params,
                                  encodes=SERVE_ENCODES, fused=False,
                                  teacher=False),
           "int8": serve_model(cfg, seed=WHISPER_SEED, params=params,
                               weight_dtype="int8", kv_dtype="int8"),
           "refusals": check_whisper_refusals(cfg, params)}
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"whisper phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 12. the overlapped loop, DeadlinePolicy, the load generator, tracing
# --------------------------------------------------------------------------

GOODPUT_REQUESTS = 64           # the open-loop trace's requests
GOODPUT_NEW = 16                # new tokens a request of that trace
GOODPUT_RATE_X = 2.0            # its arrival rate / the sync run's req/s
# its TTFT SLO: the wait of this many queued requests at the arrival rate,
# 3x the degrade ladder's first threshold (DeadlinePolicy's degrade_depth
# 2 x 4 slots), so that the unexpired backlog can pass both rungs before
# requests expire
GOODPUT_SLO_DEPTH = 24
GOODPUT_PROFILE_STEPS = 16      # decode profile steps: the pipeline's fill
#                                 is one step's launch in the timed window
PHASE_UTIL_TOL = 0.01           # trace-derived vs counter MFU / MBU
UTIL_MAX = 1.05                 # MFU / MBU above this: a timing fault


def goodput_serve(label, cfg, params, *, overlap, scheduler=None,
                  tracer=None):
    """The serve trace (SERVE_LENGTHS, 32 new tokens, uids 1 and 6
    sampled) through a fresh GPT-J engine (batch 4, max_seq 512, block
    16), synchronous or overlapped, with `scheduler` and `tracer`: exact
    launches (`check_serve_counts`, `check_gemm_templates`), every decode
    step one replay of the captured graph, no leak.  -> (engine, {uid:
    tokens}, numbers, launches)."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import InferenceEngine
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          overlap=overlap, scheduler=scheduler,
                          tracer=tracer)
    step = eng.runner.decode_step
    if not step.aux["captured"]:
        raise AssertionError(f"{label}: the decode step is not captured")
    reqs = _serve_requests(cfg)
    for q in reqs:
        eng.submit(q)
    replays0 = step.fn.replays
    t0 = time.perf_counter()
    done, launches = drive(label, eng.run,
                           path_kernels(cfg, "serve", max_seq=512))
    wall = time.perf_counter() - t0
    st = eng.stats()
    replays = step.fn.replays - replays0
    if replays != st.decode_steps:
        raise AssertionError(f"{label}: {st.decode_steps} decode steps but "
                             f"{replays} replays of its graph")
    _check_served(eng, done, len(reqs), 32, label)
    check_serve_counts(cfg, launches, st, 512, by=TEMPLATE_LAUNCHES[label])
    check_gemm_templates(cfg, st, TEMPLATE_LAUNCHES[label])
    nums = _serve_numbers(st)
    nums.update(wall_s=wall, requests_per_s=len(done) / wall,
                overlapped_steps=st.overlapped_steps,
                fast_dispatches=eng.fast_dispatches,
                host_overlap_ratio=st.host_overlap_ratio)
    _log_numbers(label, nums)
    log(f"  [{label}] {len(done)} requests in {wall:.3f} s "
        f"({nums['requests_per_s']:.2f} req/s); {st.overlapped_steps} "
        f"overlapped steps, {eng.fast_dispatches} fast-path dispatches, "
        f"host overlap ratio {st.host_overlap_ratio:.3f}")
    return eng, {q.uid: q.output for q in done}, nums, launches


def check_chained_vs_loaded(eng, label):
    """One chained dispatch of the captured step (token and pos copied on
    the device from the previous step's outputs) against one fed the same
    values through `load()`, from the same caches: next tokens, pos + 1
    and every cache leaf bit-equal.  The caches are restored and the
    chain broken afterwards, so the engine goes on as if neither ran."""
    r = eng.runner
    step = r.decode_step.fn
    if not step.chainable or step.graph is None:
        raise AssertionError(f"{label}: no captured step to chain on")
    token, pos = (t.cpu().numpy().copy() for t in step.out)
    saved = _clone_caches(r.caches)
    with torch.no_grad():
        chained = step.dispatch(None, None, None, None, chained=True).wait()
        out_c, caches_c = step.out.clone(), _clone_caches(r.caches)
        for seg, seg_s in zip(r.caches, saved):
            for k in seg:
                seg[k].copy_(seg_s[k])
        loaded = step.dispatch(token, pos, r.block_tables, r.lane).wait()
    torch.cuda.synchronize()
    diffs = [f"segment {i} {k}" for i, (a, b) in enumerate(zip(caches_c,
                                                                r.caches))
             for k in a if not torch.equal(a[k], b[k])]
    same = (np.array_equal(chained, loaded) and torch.equal(out_c, step.out)
            and not diffs)
    for seg, seg_s in zip(r.caches, saved):
        for k in seg:
            seg[k].copy_(seg_s[k])
    step.chainable = False
    leaves = sum(len(seg) for seg in r.caches)
    log(f"  [{label}] a chained replay vs a loaded one ({len(r.decoding_slots())}"
        f" live slots, pos {pos.tolist()}): tokens {chained.tolist()} vs "
        f"{loaded.tolist()}, {leaves - len(diffs)} of {leaves} cache leaves "
        f"bit-equal{f', differing: {diffs}' if diffs else ''}")
    if not same:
        raise AssertionError(f"{label}: the chained replay differs from the "
                             f"loaded one")
    return {"tokens_equal": bool(np.array_equal(chained, loaded)),
            "cache_leaves": leaves, "leaves_bit_equal": leaves - len(diffs)}


def check_trace(label, tracer, st, path):
    """The traced run's artifact: written to `path`, read back schema-clean
    (`validate_chrome_trace`), its per-phase MFU / MBU
    (`derive_phase_metrics`, the H100's peaks) within PHASE_UTIL_TOL of
    the counters' (`stats.phase_util()`), every MFU / MBU at most
    UTIL_MAX."""
    from repro_torch.serving import (derive_phase_metrics, percentiles,
                                     validate_chrome_trace)
    n_ev = tracer.write(str(path))
    doc = json.loads(path.read_text())
    problems = validate_chrome_trace(doc)
    pu = st.phase_util()
    derived = derive_phase_metrics(
        tracer.events, flops_per_token=st.model_flops_per_token,
        weight_bytes=st.weight_bytes_per_device,
        kv_bytes_per_token=st.kv_bytes_per_token)
    # the decode steps by path: one whose successor was dispatched before
    # its own fetch ran pipelined (the fast path); its busy_ms is the wall
    # from the previous commit to its own
    evs = sorted(tracer.events, key=lambda e: e["ts"])
    disp = [e["ts"] for e in evs if e["name"] == "decode_dispatch"]
    by_path = {"pipelined": [], "regular": []}
    for e in evs:
        if e["name"] != "decode_step":
            continue
        end = e["ts"] + e["dur"]
        nxt = any(e["ts"] < t < end for t in disp)
        by_path["pipelined" if nxt else "regular"].append(
            e["args"]["busy_ms"])
    steps = {k: {"steps": len(v), "busy_ms": percentiles(v)}
             for k, v in by_path.items()}
    for k, v in steps.items():
        log(f"  [{label}] {k} decode steps: {v['steps']}, step wall (the "
            f"span's busy_ms) p50 {v['busy_ms']['p50']:.3f} ms p95 "
            f"{v['busy_ms']['p95']:.3f} ms")
    rows = {}
    for phase, row in pu.items():
        d = derived.get(phase, {})
        rows[phase] = {k: {"stats": row[k], "trace": d.get(k)}
                       for k in ("time_s", "mfu", "mbu")}
        log(f"  [{label}] {phase}: MFU {row['mfu']:.4f} (trace "
            f"{d.get('mfu', float('nan')):.4f}), MBU {row['mbu']:.4f} "
            f"(trace {d.get('mbu', float('nan')):.4f}) over "
            f"{row['time_s'] * 1e3:.1f} ms of busy wall")
    log(f"  [{label}] trace: {n_ev} events ({tracer.dropped} dropped) -> "
        f"{path.relative_to(ROOT)}; schema problems: {problems or 'none'}")
    if problems or tracer.dropped:
        raise AssertionError(f"{label}: the trace is not clean: {problems}, "
                             f"{tracer.dropped} dropped")
    if set(pu) != set(derived) or not {"prefill", "decode"} <= set(pu):
        raise AssertionError(f"{label}: phases {sorted(pu)} vs trace "
                             f"{sorted(derived)}")
    for phase, row in pu.items():
        for k in ("mfu", "mbu"):
            a, b = row[k], derived[phase][k]
            if not (abs(a - b) <= PHASE_UTIL_TOL * max(abs(a), 1e-30)):
                raise AssertionError(f"{label}: {phase} {k} {a} (stats) vs "
                                     f"{b} (trace)")
            if not 0 < a <= UTIL_MAX:
                raise AssertionError(f"{label}: {phase} {k} {a} outside "
                                     f"(0, {UTIL_MAX}]")
    return {"events": n_ev, "phases": rows, "phase_util": pu,
            "decode_steps_by_path": steps}


def goodput_loadgen(cfg, params, rate_rps):
    """An open-loop loadgen trace (GOODPUT_REQUESTS Poisson arrivals at
    `rate_rps`, prompts 20-300 tokens, a quarter sampled, GOODPUT_NEW new
    tokens, a TTFT SLO of GOODPUT_SLO_DEPTH / `rate_rps`) replayed on the
    wall clock
    through the overlapped engine under DeadlinePolicy, speculating with
    GPT-J's 2-layer draft (`midrange_draft`, chain k SPEC_K).  Gates: some
    requests shed, every one typed `slo_unattainable`, some served
    degraded, and every served request's tokens held to plain decode of
    the same tasks (FCFS, no speculation) by `near_ties`."""
    from repro_torch.core.precision import BF16
    from repro_torch.serving import (ArrivalSpec, DeadlinePolicy,
                                     InferenceEngine, LoadSpec, PromptSpec,
                                     SLOSpec, SpecConfig, make_trace, replay)
    load = LoadSpec(requests=GOODPUT_REQUESTS, vocab=cfg.vocab,
                    arrival=ArrivalSpec(rate_rps=rate_rps),
                    prompts=PromptSpec(min_len=20, max_len=300,
                                       sampled_frac=0.25),
                    slo=SLOSpec(ttft_ms=1e3 * GOODPUT_SLO_DEPTH / rate_rps),
                    max_new=GOODPUT_NEW)
    trace = make_trace(load, arrival_seed=1, prompt_seed=2)
    label = "gpt-j goodput loadgen"
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16, device=DEVICE,
                          overlap=True, scheduler=DeadlinePolicy(),
                          spec=SpecConfig(draft="auto", k=SPEC_K),
                          draft_params=midrange_draft(cfg, params))
    (done, wall), launches = drive(
        label, lambda: replay(eng, trace),
        ("fused_matmul", "flash_attention", "decode_attention",
         "paged_chunk_partials"))
    st = eng.stats()
    shed = [t for t in done if t.rejection is not None]
    served = [t for t in done if t.rejection is None]
    kinds = sorted({t.rejection.kind for t in shed})
    nums = {"requests": len(trace), "rate_rps": rate_rps, "wall_s": wall,
            "served": len(served), "shed": st.requests_shed,
            "degraded": st.requests_degraded,
            "slo_attainment": st.slo_attainment, "slo_met": st.slo_met,
            "goodput_rps": st.slo_met / wall,
            "ttft_p50_ms": st.ttft_p50_ms, "ttft_p99_ms": st.ttft_p99_ms,
            "queue_wait_p99_ms": st.queue_wait_p99_ms,
            "spec_rounds": st.spec_rounds,
            "acceptance_rate": st.spec_acceptance_rate,
            "ar_tok_s": st.ar_tok_s}
    nums["ttft_slo_ms"] = load.slo.ttft_ms
    log(f"  [{label}] {len(trace)} requests at {rate_rps:.2f} req/s (TTFT "
        f"SLO {load.slo.ttft_ms:.1f} ms) over {wall:.2f} s: "
        f"{len(served)} served, {st.requests_shed} shed "
        f"({kinds}), {st.requests_degraded} degraded; SLO attainment "
        f"{st.slo_attainment:.3f} ({st.slo_met}/{st.slo_requests}), goodput "
        f"{nums['goodput_rps']:.2f} req/s; TTFT p50 {st.ttft_p50_ms:.1f} ms "
        f"p99 {st.ttft_p99_ms:.1f} ms; {st.spec_rounds} spec rounds, "
        f"acceptance {st.spec_acceptance_rate:.3f}")
    if len(done) != len(trace) or eng.has_work():
        raise AssertionError(f"{label}: {len(done)} of {len(trace)} "
                             f"resolved")
    if not (st.requests_shed > 0 and st.requests_degraded > 0):
        raise AssertionError(f"{label}: shed {st.requests_shed}, degraded "
                             f"{st.requests_degraded}: the trace did not "
                             f"reach both rungs")
    if kinds != ["slo_unattainable"] or len(shed) != st.requests_shed:
        raise AssertionError(f"{label}: shed requests typed {kinds}")
    if any(t.output for t in shed) or any(
            len(t.output) != GOODPUT_NEW for t in served):
        raise AssertionError(f"{label}: a shed request has tokens or a "
                             f"served one lacks some")
    held = eng.prefix_cache.cached_blocks if eng.prefix_cache else 0
    if eng.allocator.num_free != eng.allocator.num_blocks - held:
        raise AssertionError(f"{label}: KV blocks leaked")
    del eng
    torch.cuda.empty_cache()
    # the same tasks (a second make_trace: the same seeds give the same
    # trace), served tasks only, through plain FCFS decode
    again = {tt.task.uid: tt.task
             for tt in make_trace(load, arrival_seed=1, prompt_seed=2)}
    plain = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                            block_size=16, policy=BF16, device=DEVICE)
    for t in served:
        plain.submit(again[t.uid])
    want = {t.uid: t.output for t in plain.run()}
    del plain
    torch.cuda.empty_cache()
    ties = near_ties(cfg, params, served, want, {t.uid: t.output
                                                 for t in served}, label)
    return {"numbers": nums, "stats": st.to_dict(), "launches": launches,
            "divergences": ties}


GOODPUT_CLI = SERVE_CLI + ["--temperature", "0.8", "--top-k", "40",
                           "--overlap", "--policy", "deadline",
                           "--deadline-ms", "60000"]


def goodput_cli():
    """`python -m repro_torch.launch.serve` (its `main`) with `--overlap
    --policy deadline --deadline-ms 60000 --trace-out --metrics-out` at
    GPT-J's full width: exit 0 with its SLO and OVERLAP parts; its trace
    validated by `python -m repro_torch.serving.trace` in a child
    process; its Prometheus text snapshot parsed line by line.  The
    deadline policy takes the CLI's chunk budget (32, as the reference's
    does): every prompt of 40-160 tokens prefills in chunks."""
    import contextlib
    import io
    import os

    from repro_torch.configs import GPT_J
    from repro_torch.launch import serve
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = out_dir / "goodput_cli_trace.json"
    prom = out_dir / "goodput_cli_metrics.prom"
    argv = GOODPUT_CLI + ["--trace-out", str(trace_path), "--metrics-out",
                          str(prom)]
    need = tuple(k for k in path_kernels(GPT_J, "serve", max_seq=256)
                 if k != "flash_attention") + ("paged_chunk_partials",)
    buf = io.StringIO()

    def main():
        with contextlib.redirect_stdout(buf):
            return serve.main(argv)
    rc, launches = drive("serve CLI gpt-j goodput", main, need)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    if rc != 0 or "served 6 requests" not in text or not all(
            m in text for m in ("overlap", "SLO", "OVERLAP", "util:",
                                "trace:", "metrics:")):
        raise AssertionError("serve CLI (goodput) did not serve its trace")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    chk = subprocess.run([sys.executable, "-m", "repro_torch.serving.trace",
                          str(trace_path)], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    log(f"  python -m repro_torch.serving.trace: exit {chk.returncode}: "
        f"{chk.stdout.strip()} {chk.stderr.strip()}")
    if chk.returncode != 0:
        raise AssertionError("the CLI's trace does not validate")
    samples = {}
    for line in prom.read_text().splitlines():
        name, val = line.rsplit(" ", 1)
        samples[name] = float(val)
    if (samples.get("serving_requests_completed") != 6
            or samples.get("serving_overlapped_steps", 0) <= 0):
        raise AssertionError(f"the CLI's metrics: {samples}")
    log(f"  the CLI's metrics: {len(samples)} samples parsed, SLO "
        f"attainment {samples['serving_slo_attainment']}, "
        f"{samples['serving_overlapped_steps']:.0f} overlapped steps")
    return {"argv": argv, "stdout": text, "launches": launches,
            "trace_check": chk.stdout, "metrics_samples": len(samples)}


def phase_goodput():
    """GPT-J at full width and depth (seeded bf16) behind the overlapped
    loop, DeadlinePolicy and the tracer: the serve trace synchronous
    (FCFS) and overlapped (DeadlinePolicy, no deadline: FCFS order), then
    overlapped and traced (the slice's path): per-uid tokens identical,
    launches identical by kernel and template, overlapped steps and
    fast-path dispatches above 0; a chained replay bit-equal to a loaded
    one; each engine's decode profile (`profile_decode`: the step's wall
    against its busy time); the trace validated and its MFU / MBU against
    the counters' (`check_trace`); an open-loop loadgen trace at
    GOODPUT_RATE_X the sync run's req/s (`goodput_loadgen`: shed and
    degrade); the CLI (`goodput_cli`)."""
    from repro_torch.configs import GPT_J
    from repro_torch.models import lm
    from repro_torch.serving import DeadlinePolicy, Tracer
    t0 = time.perf_counter()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    cfg = GPT_J
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=0)
    out = {}
    runs = {}
    for key, kw in (("sync", dict(overlap=False)),
                    ("overlap", dict(overlap=True,
                                     scheduler=DeadlinePolicy())),
                    ("traced", dict(overlap=True,
                                    scheduler=DeadlinePolicy(),
                                    tracer=Tracer(capacity=1 << 20)))):
        label = f"gpt-j goodput {key}"
        eng, toks, nums, launches = goodput_serve(label, cfg, params, **kw)
        runs[key] = (toks, launches, TEMPLATE_LAUNCHES[label])
        out[key] = {"numbers": nums, "stats": eng.stats().to_dict(),
                    "launches": launches}
        if key == "traced":
            out[key]["trace"] = check_trace(
                label, eng.tracer, eng.stats(),
                ROOT / "chiprun_out" / "goodput_trace.json")
        else:
            out[key]["decode_profile"] = profile_decode(
                eng, cfg, np.random.default_rng(0),
                steps=GOODPUT_PROFILE_STEPS)
        if key == "sync":
            # a mid-flight batch: every slot decoding, the chain valid
            for q in _serve_requests(cfg, (120, 150, 90, 200), seed=5,
                                     uid0=40):
                eng.submit(q)
            for _ in range(50):
                eng.step()
                if len(eng.runner.decoding_slots()) == eng.runner.B:
                    break
            eng.step()
            out["chained_vs_loaded"] = check_chained_vs_loaded(eng, label)
            eng.run()
            _check_served(eng, eng.completed[-4:], 4, 32, f"{label} chain")
        del eng
        torch.cuda.empty_cache()
    base_toks, base_launches, base_by = runs["sync"]
    for key in ("overlap", "traced"):
        toks, launches, by = runs[key]
        if toks != base_toks:
            bad = sorted(u for u in toks if toks[u] != base_toks[u])
            raise AssertionError(f"goodput {key}: tokens differ from the "
                                 f"sync run's for uids {bad}")
        if launches != base_launches or by != base_by:
            raise AssertionError(f"goodput {key}: launches {launches} / "
                                 f"{by} != sync {base_launches} / "
                                 f"{base_by}")
        n = out[key]["numbers"]
        if not (n["overlapped_steps"] > 0 and n["fast_dispatches"] > 0):
            raise AssertionError(f"goodput {key}: {n['overlapped_steps']} "
                                 f"overlapped steps, "
                                 f"{n['fast_dispatches']} fast dispatches")
    log("  [gpt-j goodput] overlapped and traced runs: tokens and launches "
        "(by kernel and template) identical to the sync run's")
    for key in ("sync", "overlap"):
        prof = out[key]["decode_profile"]
        n = out[key]["numbers"]
        log(f"  [gpt-j goodput {key}] AR {n['ar_tok_s']:.1f} tok/s, decode "
            f"step p50 {n['decode_step_p50_ms']:.2f} ms p95 "
            f"{n['decode_step_p95_ms']:.2f} ms; profiled step wall "
            f"{prof['step_ms']:.2f} ms vs device busy "
            f"{_ms(prof.get('device_busy_ms'))}")
    rate = GOODPUT_RATE_X * out["sync"]["numbers"]["requests_per_s"]
    out["loadgen"] = goodput_loadgen(cfg, params, rate)
    del params
    torch.cuda.empty_cache()
    out["cli"] = goodput_cli()
    out["seconds"] = time.perf_counter() - t0
    log(f"goodput phase: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 13. train
# --------------------------------------------------------------------------

TRAIN_TAG = "train"             # every drive label of a train path
# a Function's card gradients vs torch.autograd through its plain version on
# the card: the explicit backward rounds its products' operands (dZ, the
# normalized x, P) and its outputs to bf16 where the plain route keeps fp32
# until the input's dtype
TRAIN_GRAD_TOL = 2e-2
TEACHER_LAYERS = 4              # the teacher gate's cut of GPT3-XL
TEACHER_K = 2.0                 # gate: max(TEACHER_MIN, k x bf16 floor)
TEACHER_MIN = 5e-2
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
TRAIN_LR = 3e-4                 # constant LR of the repeated-batch run
TRAIN_LOSS_DROP = 0.5           # the loss must fall at least this much
VIT_TRAIN_BATCH = 8
TRAIN_CLI_CKPT = ROOT / "build" / "train_cli_ckpt"
TRAIN_CLI_TIMEOUT = 420
# kernel names of the hand-written sources (csrc/*.cu), for the step's
# device-time split: hand kernels / cuBLAS / the rest
HAND_KERNELS = GEMM_KERNELS + ("flash", "norm_kernel")
LIB_GEMM = ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "cublas")

TRAIN_GEMM_CASES = (   # label, K, N, norm, activation, residual, fp32 out
    ("LN q M=2048", 2048, 2048, "layernorm", "none", False, False),
    ("LN+i_gelu up M=2048", 2048, 8192, "layernorm", "i_gelu", False, False),
    ("+res down M=2048", 8192, 2048, "none", "none", True, False),
    ("CE head fp32 M=2048", 2048, 50432, "none", "none", False, True))
TRAIN_FLASH_CASES = (   # label, B, S, H, D, causal
    ("B=4 S=512 H=16 D=128 causal", 4, 512, 16, 128, True),
    ("ViT-B B=8 S=197 H=12 D=64", 8, 197, 12, 64, False))
TRAIN_NORM_SHAPE = (2048, 2048)


def _grad_gate(name, case, inputs, kernel, plain, library, lib_name, nbytes,
               flops, rows, g):
    """Forward + backward of `kernel` (the Function), `plain` (autograd
    through the plain version) and `library` (one PyTorch autograd route),
    each on the card from the same inputs and the same seeded dY: every
    input's gradient, max|k - p| / max|p| (the worst input), gated at
    TRAIN_GRAD_TOL; CUDA-event times of a forward + backward."""
    with torch.no_grad():
        y0 = kernel()
    dy = torch.randn(y0.shape, generator=g, device=DEVICE).to(y0.dtype)
    del y0

    def fwd_bwd(f):
        return lambda: torch.autograd.grad(f(), inputs, dy)

    gk, gp = fwd_bwd(kernel)(), fwd_bwd(plain)()
    err, rel = 0.0, 0.0
    for a, b in zip(gk, gp):
        e, r = rel_err(a, b)
        err, rel = max(err, e), max(rel, r)
    del gk, gp
    ms = time_ms(fwd_bwd(kernel), iters=10)
    plain_ms = time_ms(fwd_bwd(plain), iters=3, warmup=1)
    lib_ms = time_ms(fwd_bwd(library), iters=10)
    r = _row(case, err, rel, TRAIN_GRAD_TOL, ms, plain_ms, lib_ms, nbytes,
             flops)
    _report(name, r, lib_name)
    rows.setdefault(name, []).append(r)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def check_train_grads(rows):
    """The three Functions of the train path at GPT3-XL's shapes, bf16
    (`_grad_gate`): the fused GEMM (row 1) at M = 2048 as q / k / v (LN
    prologue), w1 (LN + i-GELU), w2 (residual) and the CE head (fp32 out),
    beside F.layer_norm / F.linear / F.gelu; flash (row 3) causal at B 4 x
    512 and bidirectional at ViT-B's 197 x 12 x 64, beside SDPA; LayerNorm
    (row 8) at [2048, 2048] beside F.layer_norm.  Bounds count each input
    and dY read once and y and every gradient written once, and the
    products a forward and a backward need (GEMM 6 M K N, attention six
    S x S x D products, half of them causal)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.epilogue import LN_EPS, Epilogue, Prologue
    F = torch.nn.functional
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(28)
    log("train: the kernels' autograd Functions vs autograd through the "
        "plain versions (bf16, on the card):")

    def leaf(*shape, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=g, device=DEVICE) * scale + shift
        return t.to(bf).requires_grad_(True)

    M = TRAIN_BATCH * TRAIN_SEQ
    for label, K, N, norm, act, res, f32 in TRAIN_GEMM_CASES:
        x, w = leaf(M, K), leaf(K, N, scale=0.02)
        ln = norm == "layernorm"
        gam = leaf(K, scale=0.1, shift=1.0) if ln else None
        bet = leaf(K, scale=0.1) if ln else None
        r = leaf(M, N) if res else None
        od = torch.float32 if f32 else None
        ins = [t for t in (x, w, gam, bet, r) if t is not None]
        # the three routes run inside this iteration: closures suffice
        def kernel():
            pro = Prologue("layernorm", gam, bet, LN_EPS) if ln else None
            return ops.fused_matmul(
                x, w, prologue=pro,
                epilogue=Epilogue(activation=act, residual=r, out_dtype=od),
                compute_dtype=bf, dot_dtype=od or bf)

        def plain():
            return mm.matmul_plain(x, w, norm=norm, gamma=gam, nbeta=bet,
                                   residual=r, activation=act, eps=LN_EPS,
                                   out_dtype=od or bf)

        def library():
            h = F.layer_norm(x, (K,), gam, bet, LN_EPS) if ln else x
            y = F.linear(h, w.t())
            if act != "none":
                y = F.gelu(y, approximate="tanh")
            if r is not None:
                y = r + y
            return y.float() if f32 else y

        out_bytes = M * N * (4 if f32 else 2)
        nbytes = 2 * (_nbytes(*ins) + out_bytes)    # in + dY, y + grads
        _grad_gate("fused_matmul_grad", label, ins, kernel, plain, library,
                   "F.linear", nbytes, 6 * M * K * N, rows, g)
        del x, w, gam, bet, r, ins
    for label, B, S, H, D, causal in TRAIN_FLASH_CASES:
        q, k, v = (leaf(B, S, H, D) for _ in range(3))
        ins = [q, k, v]
        kernel = lambda: ops.flash_attention(q, k, v, causal=causal)
        plain = lambda: fa.flash_attention_plain(q, k, v, causal=causal)
        library = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal).transpose(1, 2)
        flops = 6 * 2 * B * H * S * S * D * (0.5 if causal else 1.0)
        nbytes = 2 * (_nbytes(*ins) + _nbytes(q))
        _grad_gate("flash_attention_grad", label, ins, kernel, plain,
                   library, "SDPA", nbytes, flops, rows, g)
        del q, k, v, ins
    T, D = TRAIN_NORM_SHAPE
    x, gam, bet = leaf(T, D), leaf(D, scale=0.1, shift=1.0), leaf(D,
                                                                 scale=0.1)
    _grad_gate("layernorm_grad", f"[{T}, {D}]", [x, gam, bet],
               lambda: ops.layernorm(x, gam, bet),
               lambda: rn.layernorm_plain(x, gam, bet),
               lambda: F.layer_norm(x, (D,), gam, bet, LN_EPS),
               "F.layer_norm", 2 * (_nbytes(x, gam, bet) + _nbytes(x)),
               12 * T * D, rows, g)


def train_counts(cfg):
    """Hand-kernel launches of one train step of `cfg` (fused chain, every
    layer rematerialized, one CE chunk): per layer the six fused GEMMs (q /
    k / v with the LN prologue, o and w2 with the residual, w1 with LN +
    i-GELU) in the forward and again in the recompute, plus w1's
    pre-activation in the backward (13); the CE head's GEMM in the forward
    and the recompute (2); flash twice a layer; LayerNorm once (the final
    norm, outside the checkpointed layers).  All GEMMs at M = B x S run
    the wgmma template, every flash launch too."""
    L = cfg.n_layers
    return {"fused_matmul": 13 * L + 2, "flash_attention": 2 * L,
            "layernorm": 1}


def check_train_counts(path, launches, want, gemm_wgmma=None):
    """Exact launches of a train path: `want` for its kernels, 0 for every
    other, and `gemm_wgmma` GEMM launches (default: every one) and every
    flash launch on the wgmma template (`drive` already fails an fma32
    GEMM or a non-wgmma flash launch)."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    by = TEMPLATE_LAUNCHES[path]
    wg = {"fused_matmul": by["fused_matmul"]["wgmma"],
          "flash_attention": by["flash_attention"]["wgmma"]}
    want_wg = {"fused_matmul": want["fused_matmul"] if gemm_wgmma is None
               else gemm_wgmma, "flash_attention": want["flash_attention"]}
    if launches != full or wg != want_wg:
        raise AssertionError(f"{path}: launches {launches} (wgmma {wg}), "
                             f"expected {full} (wgmma {want_wg})")
    log(f"  [{path}] exact launches: {want}, wgmma {want_wg}")


def _teacher_gate(label, got, want, want32):
    """max|g - w| / max|w| <= max(TEACHER_MIN, TEACHER_K x floor), the
    floor the same gap between the plain bf16 and plain fp32 results."""
    rel = rel_err(got, want)[1]
    floor = rel_err(want, want32)[1]
    tol = max(TEACHER_MIN, TEACHER_K * floor)
    if not (bool(torch.isfinite(got).all()) and rel <= tol):
        raise AssertionError(f"teacher gate {label}: rel {rel:.3e} > tol "
                             f"{tol:.3e} (floor {floor:.3e})")
    return {"rel": rel, "floor": floor, "tol": tol}


def _scalar_gate(label, got, want, want32):
    return _teacher_gate(label, torch.tensor([float(got)]),
                         torch.tensor([float(want)]),
                         torch.tensor([float(want32)]))


def _gate_trees(label, got, want, want32):
    """`_teacher_gate` on every leaf -> the worst leaf's numbers."""
    from repro_torch.models.params import tree_flatten
    worst = {"rel": 0.0, "floor": 0.0, "tol": 0.0, "leaf": None}
    for i, (a, b, c) in enumerate(zip(tree_flatten(got)[0],
                                      tree_flatten(want)[0],
                                      tree_flatten(want32)[0])):
        r = _teacher_gate(f"{label} leaf {i}", a, b, c)
        if r["rel"] / r["tol"] > worst["rel"] / max(worst["tol"], 1e-30):
            worst = dict(r, leaf=i)
    return worst


def train_teacher(cfg, *, seed):
    """One train step of `cfg` (GPT3-XL at full width, cut in depth) from
    one seeded fp32 state and batch under kernel mode `cuda` (the hand
    kernels and their Functions), `ref` (the ref.py port, torch autograd)
    in bf16 and `ref` in fp32: loss, grad norm and every leaf's gradient of
    the kernel path held to plain bf16 at max(5e-2, 2 x the floor), the
    floor plain bf16 against plain fp32; the step's launches exact
    (`train_counts`)."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map
    from repro_torch.optim import adamw_init
    t0 = time.perf_counter()
    master = lm.init_lm(cfg, dtype=torch.float32, device=DEVICE, seed=seed)
    batch = SyntheticStream(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                            seed=seed, device=DEVICE).batch(0)
    res = {}
    for key, mode, pol in (("cuda", "cuda", BF16), ("ref", "ref", BF16),
                           ("ref_fp32", "ref", FP32)):
        b = make_train_step(cfg, policy=pol,
                            lr_fn=lambda s: TRAIN_LR, device=DEVICE)
        state = {"step": torch.zeros((), dtype=torch.int32, device=DEVICE),
                 "params": tree_map(torch.clone, master)}
        state["opt"] = adamw_init(state["params"])
        with ops.kernel_mode(mode):
            m, grads = b.aux["loss_and_grads"](state["params"], batch)
            if key == "cuda":
                path = f"{TRAIN_TAG} teacher {cfg.name} L{cfg.n_layers}"
                (_, sm), launches = drive(
                    path, lambda: b.fn(state, batch),
                    ("fused_matmul", "flash_attention", "layernorm"))
                check_train_counts(path, launches, train_counts(cfg))
            else:
                _, sm = b.fn(state, batch)
        res[key] = {"loss": float(m["loss"]), "grads": grads,
                    "step_loss": float(sm["loss"]),
                    "grad_norm": float(sm["grad_norm"])}
        del state
    c, r, r32 = res["cuda"], res["ref"], res["ref_fp32"]
    out = {"layers": cfg.n_layers}
    for k in ("loss", "grad_norm"):
        out[k] = dict(_scalar_gate(f"{cfg.name} {k}", c[k], r[k], r32[k]),
                      cuda=c[k], ref=r[k], ref_fp32=r32[k])
        log(f"  teacher {cfg.name} L{cfg.n_layers} {k}: cuda {c[k]:.6f} ref "
            f"bf16 {r[k]:.6f} ref fp32 {r32[k]:.6f} (rel "
            f"{out[k]['rel']:.2e}, tol {out[k]['tol']:.2e})")
    if c["step_loss"] != c["loss"]:
        raise AssertionError("the step's loss differs from loss_and_grads")
    out["grads"] = _gate_trees(f"{cfg.name} grads", c["grads"], r["grads"],
                               r32["grads"])
    out["seconds"] = time.perf_counter() - t0
    log(f"  teacher {cfg.name} L{cfg.n_layers} grads: worst leaf "
        f"{out['grads']['leaf']} rel {out['grads']['rel']:.2e} (floor "
        f"{out['grads']['floor']:.2e}, tol {out['grads']['tol']:.2e}); "
        f"{out['seconds']:.1f} s")
    del res, master
    torch.cuda.empty_cache()
    return out


def _step_profile(fn, ranges=()):
    """One call of `fn` under torch.profiler (CPU + CUDA): (device busy ms,
    {kernel: (ms, launches)}, wall ms of the profiled call, {range: (device
    ms, kernel launches)} of each `torch.profiler.record_function` range
    named in `ranges`: the kernels launched inside it and its children).
    The ranges' own device-side annotations are not kernels and are left
    out of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = {ev.key: (getattr(ev, "self_device_time_total", 0.0) / 1e3,
                    ev.count)
           for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and ev.key not in ranges}

    def kernels(ev):
        ks = list(ev.kernels)
        for ch in ev.cpu_children:
            ks += kernels(ch)
        return ks

    parts = {}
    for ev in prof.events():
        if ev.name in ranges and \
                ev.device_type == torch.autograd.DeviceType.CPU:
            ks = kernels(ev)
            ms, n = parts.get(ev.name, (0.0, 0))
            parts[ev.name] = (ms + sum(k.duration for k in ks) / 1e3,
                              n + len(ks))
    return sum(t for t, _ in dev.values()), dev, wall, parts


def train_whole(cfg, *, seed, card):
    """GPT3-XL whole (all layers, B 4 x 512, bf16 policy, seeded fp32
    master and SyntheticStream(seed=0)) through `make_train_step` at a
    constant LR on one repeated batch: the first step driven with exact
    launches, TRAIN_WARMUP steps, then TRAIN_TIMED timed steps (CUDA
    events; host wall beside), the loss falling by TRAIN_LOSS_DROP; step
    p50 / p95, tokens/s, MFU (analysis.roofline.model_flops over the step
    over 989 TFLOP/s), peak allocated GB; one step profiled (busy share,
    top kernels, hand kernels against cuBLAS, device ops a step) and the
    device time and kernels of the clip and of AdamW (the ranges of
    `steps.TRAIN_RANGES`); the rest of the busy time is the forward and
    backward (whose backward kernels launch from autograd's device thread,
    outside any range the step's thread opens)."""
    import gc
    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.steps import TRAIN_RANGES, make_train_step
    shape = ShapeConfig("chip_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    b = make_train_step(cfg, lr_fn=lambda s: TRAIN_LR, device=DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    state = b.aux["init_state"](seed)
    stream = SyntheticStream(cfg, global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, seed=0, device=DEVICE)
    batch = stream.batch(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    state_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
    log(f"train: {cfg.name} {cfg.n_layers} layers, {n_params:,} params, "
        f"state {state_gb:.2f} GB (fp32 master, m, v), init "
        f"{time.perf_counter() - t0:.1f} s")
    path = f"{TRAIN_TAG} {cfg.name}"
    box = {}

    def first():
        box["state"], box["m"] = b.fn(state, batch)

    _, launches = drive(path, first,
                        ("fused_matmul", "flash_attention", "layernorm"))
    check_train_counts(path, launches, train_counts(cfg))
    state = box.pop("state")
    losses = [float(box.pop("m")["loss"])]
    for _ in range(TRAIN_WARMUP - 1):
        state, m = b.fn(state, batch)
        losses.append(float(m["loss"]))
    dev_ms, host_ms_ = [], []
    for _ in range(TRAIN_TIMED):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        state, m = b.fn(state, batch)
        e1.record()
        e1.synchronize()
        host_ms_.append((time.perf_counter() - h0) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    if not all(np.isfinite(losses)) or \
            losses[-1] > losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"{path}: the loss on a repeated batch did not "
                             f"fall by {TRAIN_LOSS_DROP}: {losses}")
    p50, p95 = (float(np.percentile(dev_ms, q)) for q in (50, 95))
    flops = model_flops(cfg, shape)
    toks = TRAIN_BATCH * TRAIN_SEQ
    out = {"params": n_params, "state_gb": state_gb, "peak_gb": peak,
           "losses": losses, "step_ms": dev_ms, "host_step_ms": host_ms_,
           "step_ms_p50": p50, "step_ms_p95": p95,
           "tokens_per_s": toks / p50 * 1e3, "model_flops": flops,
           "mfu": flops / (p50 / 1e3) / PEAK_BF16, "launches": launches,
           "base_gb": base_gb}
    log(f"  {path}: step p50 {p50:.1f} ms p95 {p95:.1f} ms (CUDA events; "
        f"host p50 {np.percentile(host_ms_, 50):.1f} ms), "
        f"{out['tokens_per_s']:.0f} tokens/s, MFU {out['mfu']:.3f} "
        f"({flops:.3e} model FLOPs a step), peak {peak:.2f} GB above the "
        f"{base_gb:.2f} GB held before; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {card}")
    busy, dev, wall, parts = _step_profile(lambda: b.fn(state, batch),
                                           TRAIN_RANGES)
    if set(parts) != set(TRAIN_RANGES):
        raise AssertionError(f"{path}: the profiled step has the ranges "
                             f"{sorted(parts)}, not {TRAIN_RANGES}")
    hand = sum(t for k, (t, _) in dev.items()
               if any(h in k for h in HAND_KERNELS))
    lib = sum(t for k, (t, _) in dev.items()
              if not any(h in k for h in HAND_KERNELS)
              and any(x in k for x in LIB_GEMM))
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    out["profile"] = {
        "wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
        "hand_kernels_ms": hand, "library_gemm_ms": lib,
        "other_ms": busy - hand - lib,
        "device_ops": sum(n for _, n in dev.values()),
        "parts": {k: {"ms": t, "launches": n} for k, (t, n) in parts.items()},
        "forward_backward_ms": busy - sum(t for t, _ in parts.values()),
        "top": [{"kernel": k, "ms": t, "launches": n} for k, (t, n) in top]}
    log(f"  {path} profiled step: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall:.1%}) in "
        f"{out['profile']['device_ops']} device ops; hand kernels "
        f"{hand:.1f} ms ({hand / busy:.1%}), cuBLAS matmul {lib:.1f} ms "
        f"({lib / busy:.1%}), other {busy - hand - lib:.1f} ms; "
        + ", ".join(f"{k.split('.')[-1]} {t:.1f} ms in {n} kernels"
                    for k, (t, n) in parts.items())
        + f", forward + backward the other "
          f"{out['profile']['forward_backward_ms']:.1f} ms")
    for k, (t, n) in top:
        log(f"    device {t:9.3f} ms  x{n:<5d} {k[:80]}")
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cli(key, args, out):
    """One `python -m repro_torch.launch.train` child process: its lines,
    logged and kept in `out[key]`; a non-zero exit fails the run."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *args], capture_output=True, text=True,
                       timeout=TRAIN_CLI_TIMEOUT, env=env, cwd=ROOT)
    secs = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    log(f"  train cli {key} (rc {r.returncode}, {secs:.1f} s):")
    for line in lines:
        log(f"    {line}")
    if r.returncode != 0:
        raise AssertionError(f"train cli {key} failed:\n{r.stderr[-3000:]}")
    out[key] = {"seconds": secs, "args": args, "lines": lines}
    return lines


def _cli_here(key, args, out):
    """`repro_torch.launch.train.main(args)` in this process, its printed
    lines captured, logged and kept in `out[key]`: the run a child process
    is compared with, without a second process's start-up."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(args)
    secs = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    log(f"  train main() {key} (rc {rc}, {secs:.1f} s, in this process):")
    for line in lines:
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"train main() {key} returned {rc}")
    out[key] = {"seconds": secs, "args": args, "lines": lines,
                "in_process": True}
    return lines


def train_cli(cfg, *, card):
    """The train CLI (`python -m repro_torch.launch.train`) in child
    processes, and restart-exactness through its checkpoint.  The chip
    machine allows 45 GiB of disk writes a call and GPT3-XL's train state
    is 26.6 GB a checkpoint, so one full-size checkpoint is written:
      * GPT3-XL whole, 3 steps, checkpointed at the end (`--steps 3
        --checkpoint-dir`).  In this process, the same schedule from the
        same seeds runs uninterrupted through step 4; the child's step-3
        checkpoint restored into a fresh state and stepped once must give
        step 4's loss and grad norm bit for bit (the card's step is
        deterministic: `F.embedding`'s sorted backward, the kernels' fixed
        split order, cuBLAS at fixed shapes), and the child's printed
        losses are this process's.
      * The CLI's resume at `--reduced` size on the card: 5 steps with a
        checkpoint every 3 (the uninterrupted run, through the CLI's
        `main` in this process: the CLI's cosine schedule spans --steps,
        so a shorter first run would train another schedule), the step-5
        checkpoint removed, then `--resume` in a child process: it
        restores step 3, and its lines for steps 4 and 5 and its final
        loss are the uninterrupted run's."""
    import gc
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import cosine_schedule
    shutil.rmtree(TRAIN_CLI_CKPT, ignore_errors=True)
    out = {}
    k, lr = 3, 3e-4                    # the CLI's default --lr
    full = _cli("gpt3-xl whole", [
        "--arch", cfg.name, "--steps", str(k), "--global-batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--checkpoint-dir",
        str(TRAIN_CLI_CKPT), "--log-every", "1"], out)
    b = make_train_step(cfg, device=DEVICE, lr_fn=cosine_schedule(
        lr, min(100, k // 10 + 1), k))
    stream = SyntheticStream(cfg, global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, seed=0, device=DEVICE)
    t0 = time.perf_counter()
    state = Checkpointer(str(TRAIN_CLI_CKPT)).restore(
        b.aux["state_like"](), step=k, device=DEVICE)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if int(state["step"]) != k:
        raise AssertionError(f"restored step {int(state['step'])}")
    state, m = b.fn(state, stream.batch(k))
    got = (m["loss"].item(), m["grad_norm"].item())
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    state = b.aux["init_state"](0)
    losses = []
    for step in range(k + 1):
        state, m = b.fn(state, stream.batch(step))
        losses.append(m["loss"].item())
    want = (m["loss"].item(), m["grad_norm"].item())
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_gb = sum(p.stat().st_size for p in
                  TRAIN_CLI_CKPT.rglob("*.npy")) / 1e9
    out["restart"] = {"step": k + 1, "uninterrupted": want,
                      "restored": got, "ckpt_gb": ckpt_gb,
                      "restore_s": restore_s}
    log(f"  {cfg.name} restart: step {k + 1} loss / grad norm {want} "
        f"uninterrupted here, {got} from the CLI's step-{k} checkpoint "
        f"({ckpt_gb:.1f} GB restored in {restore_s:.1f} s; {card})")
    if want != got:
        raise AssertionError(f"restart-exact: {want} vs {got}")
    printed = [f"loss {x:.4f} " for x in losses[:k]]
    if any(p not in line for p, line in zip(printed, full)):
        raise AssertionError(f"this process's losses {losses[:k]} are not "
                             f"the child's: {full}")
    shutil.rmtree(TRAIN_CLI_CKPT, ignore_errors=True)
    small = ["--arch", cfg.name, "--reduced", "--steps", "5",
             "--global-batch", str(TRAIN_BATCH), "--seq", "64",
             "--checkpoint-dir", str(TRAIN_CLI_CKPT), "--log-every", "1"]
    uninterrupted = _cli_here("reduced uninterrupted",
                              small + ["--checkpoint-every", "3"], out)
    steps = sorted(p.name for p in TRAIN_CLI_CKPT.iterdir())
    if steps != ["step_00000003", "step_00000005"]:
        raise AssertionError(f"train cli: checkpoints {steps}")
    shutil.rmtree(TRAIN_CLI_CKPT / "step_00000005")
    res = _cli("reduced resumed", small + ["--resume"], out)
    if res[0] != "resumed from step 3" or res[1:] != uninterrupted[3:]:
        raise AssertionError(f"train cli: the resumed run's lines {res} are "
                             f"not the uninterrupted run's "
                             f"{uninterrupted[3:]}")
    shutil.rmtree(TRAIN_CLI_CKPT, ignore_errors=True)
    return out


def vit_train_counts(cfg, fused):
    """One vit_loss forward + backward (no rematerialization): flash once a
    layer; the fused chain's GEMMs 6 a layer plus patchify and head, plus
    w1's pre-activation in the backward (LayerNorm none: the final norm is
    the head's prologue); the unfused chain's 6 a layer plus 2 (the
    activation outside the GEMMs) and LayerNorm 2 a layer plus the final
    norm.  The head (M = B) streams; every other GEMM runs wgmma."""
    L = cfg.n_layers
    if fused:
        return {"fused_matmul": 7 * L + 2, "flash_attention": L}, 7 * L + 1
    return ({"fused_matmul": 6 * L + 2, "flash_attention": L,
             "layernorm": 2 * L + 1}, 6 * L + 1)


def train_vit(cfg, *, seed):
    """`vit_loss` forward and backward of `cfg` at full width and depth, a
    batch of VIT_TRAIN_BATCH seeded images, seeded fp32 master params cast
    to bf16 in the graph: the fused and unfused kernel paths (exact
    launches) held to plain bf16 by the teacher gate (loss and every leaf's
    gradient), the floor plain bf16 against plain fp32."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.kernels import ops
    from repro_torch.models import vit
    from repro_torch.models.params import (tree_flatten, tree_map,
                                           tree_unflatten)
    B = VIT_TRAIN_BATCH
    master = vit.init_vit(cfg, dtype=torch.float32, device=DEVICE, seed=seed)
    rng = np.random.default_rng(seed)
    patches = torch.tensor(rng.standard_normal(
        (B, cfg.image_seq - 1, vit.PATCH_DIM)).astype(np.float32),
        device=DEVICE)
    labels = torch.tensor(rng.integers(0, cfg.n_classes, B), device=DEVICE)

    def run(mode, pol, fused=True):
        leaves, tdef = tree_flatten(master)
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with ops.kernel_mode(mode):
            loss, m = vit.vit_loss(
                tree_map(lambda p: p.to(pol.param_dtype),
                         tree_unflatten(tdef, xs)),
                patches.to(pol.compute_dtype), labels, cfg=cfg, policy=pol,
                fused=fused)
            grads = torch.autograd.grad(loss, xs)
        return float(loss.detach()), tree_unflatten(tdef, list(grads))

    ref, ref32 = run("ref", BF16), run("ref", FP32)
    out = {"batch": B}
    for path_key, fused in (("fused", True), ("unfused", False)):
        path = f"{TRAIN_TAG} {cfg.name} vit_loss {path_key}"
        want, wg = vit_train_counts(cfg, fused)
        (loss, grads), launches = drive(
            path, lambda: run("cuda", BF16, fused),
            tuple(want))
        check_train_counts(path, launches, want, gemm_wgmma=wg)
        by = TEMPLATE_LAUNCHES[path]["fused_matmul"]
        if by["stream"] != 1:
            raise AssertionError(f"{path}: GEMM templates {by}")
        g_loss = _scalar_gate(f"{path} loss", loss, ref[0], ref32[0])
        g_grads = _gate_trees(f"{path} grads", grads, ref[1], ref32[1])
        out[path_key] = {"loss": loss, "loss_gate": g_loss,
                         "grads": g_grads, "launches": launches}
        log(f"  {path}: loss {loss:.6f} vs plain bf16 {ref[0]:.6f} (rel "
            f"{g_loss['rel']:.2e}, tol {g_loss['tol']:.2e}); grads worst "
            f"leaf {g_grads['leaf']} rel {g_grads['rel']:.2e} (floor "
            f"{g_grads['floor']:.2e}, tol {g_grads['tol']:.2e})")
    del master
    torch.cuda.empty_cache()
    return out


def phase_train(rows, card):
    """Training on the card: the Functions' gates (`check_train_grads`),
    the teacher gate at GPT3-XL width cut to TEACHER_LAYERS layers, GPT3-XL
    whole (`train_whole`: timed steps, profile), the train CLI with
    restart-exactness through its checkpoint (`train_cli`), ViT-B's
    `vit_loss` (`train_vit`)."""
    import gc
    from repro_torch.configs import GPT3_XL, VIT_B
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out, parts = {}, {}
    for key, run in (
            ("grads", lambda: check_train_grads(rows)),
            ("teacher", lambda: train_teacher(
                dense_cut(GPT3_XL, TEACHER_LAYERS), seed=5)),
            ("whole", lambda: train_whole(GPT3_XL, seed=0, card=card)),
            ("cli", lambda: train_cli(GPT3_XL, card=card)),
            ("vit", lambda: train_vit(VIT_B, seed=8))):
        t1 = time.perf_counter()
        r = run()
        parts[key] = time.perf_counter() - t1
        if r is not None:
            out[key] = r
    out["seconds"] = time.perf_counter() - t0
    out["part_seconds"] = parts
    log(f"train phase: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {   # name -> (source, TPU kernel replaced, case in the line)
    "fused_matmul": (CSRC + "fused_matmul.cu",
                     "src/repro/kernels/matmul.py:161", "mlp_up M=4"),
    "fused_matmul_swiglu": (CSRC + "fused_swiglu.cu",
                            "src/repro/kernels/matmul.py:329",
                            "M=4 rmsnorm"),
    # its expert form: the TPU kernel vmapped over an MoE layer's experts
    # (src/repro/kernels/ops.py:350 expert_swiglu)
    "expert_swiglu": (CSRC + "fused_swiglu.cu",
                      "src/repro/kernels/matmul.py:329", "8x7b decode C=2"),
    # the int8-weight / int8-pool forms of the same sources
    "fused_matmul_int8": (CSRC + "fused_matmul.cu",
                          "src/repro/kernels/matmul.py:161", "mlp_up M=4"),
    "fused_matmul_swiglu_int8": (CSRC + "fused_swiglu.cu",
                                 "src/repro/kernels/matmul.py:329",
                                 "M=4 rmsnorm"),
    "paged_decode_partials_int8": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:321",
        "B=4 H=24/KV=8 D=128 BS=16 len 1/137/300/512"),
    "paged_decode_attention_int8": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:297",
        "B=4 H=24/KV=8 D=128 BS=16 len 1/137/300/512"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94",
                        "phi4 S=512 H24/KV8 D=128"),
    "paged_decode_partials": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:321",
        "B=4 H=24/KV=8 D=128 BS=16 len 1/137/300/512"),
    "paged_decode_attention": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:297",
        "B=4 H=24/KV=8 D=128 BS=16 len 1/137/300/512"),
    "decode_attention": (CSRC + "decode_attention.cu",
                         "src/repro/kernels/flash_decode.py:116",
                         DECODE_CASES[0][0]),
    "rmsnorm": (CSRC + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:42",
                "[4, 3072]"),
    "layernorm": (CSRC + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:65",
                  "[4, 3072]"),
    "residual_rmsnorm": (CSRC + "rmsnorm.cu",
                         "src/repro/kernels/rmsnorm.py:136", "[4, 1600]"),
    "residual_layernorm": (CSRC + "rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:146", "[4, 1600]"),
    "ssd_multihead": (CSRC + "ssd.cu", "src/repro/kernels/ssd.py:141",
                      "B=1 S=512 H=64 P=64 N=16"),
    "ssd": (CSRC + "ssd.cu", "src/repro/kernels/ssd.py:174",
            "B=1 S=512 H=80 P=64 N=128"),
    # the fold's G = 16 form (chatglm3-6b: 32 query heads over 2 kv heads)
    "paged_decode_partials_g16": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:321",
        "B=4 H=32/KV=2 D=128 BS=16 len 1/137/300/512"),
    "paged_decode_attention_g16": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:297",
        "B=4 H=32/KV=2 D=128 BS=16 len 1/137/300/512"),
    "paged_decode_attention_int8_g16": (
        CSRC + "paged_decode.cu", "src/repro/kernels/flash_decode.py:297",
        "B=4 H=32/KV=2 D=128 BS=16 len 1/137/300/512"),
    "decode_attention_g16": (CSRC + "decode_attention.cu",
                             "src/repro/kernels/flash_decode.py:116",
                             DECODE_CASES[-1][0]),
    # the gradient paths of the train slice: each kernel's autograd
    # Function, its forward the hand kernel, its backward torch ops
    "fused_matmul_grad": (CSRC + "fused_matmul.cu",
                          "src/repro/kernels/matmul.py:161",
                          "LN+i_gelu up M=2048"),
    "flash_attention_grad": (CSRC + "flash_attention.cu",
                             "src/repro/kernels/flash_attention.py:94",
                             "B=4 S=512 H=16 D=128 causal"),
    "layernorm_grad": (CSRC + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:65",
                       "[2048, 2048]"),
}
# the gradient entries count their wrapper's launches on the train paths
# (forward, recompute and the backward's pre-activation GEMM)
GRAD_OF = {"fused_matmul_grad": "fused_matmul",
           "flash_attention_grad": "flash_attention",
           "layernorm_grad": "layernorm"}
# line entries whose kernels-phase rows sit under another name
ROWS_OF = {"paged_decode_partials_g16": "paged_decode_partials",
           "paged_decode_attention_g16": "paged_decode_attention",
           "paged_decode_attention_int8_g16": "paged_decode_attention_int8",
           "decode_attention_g16": "decode_attention"}
# the G = 16 forms count the launches of chatglm3-6b's paths (GLM_TAG):
# every decode launch there runs the G = 16 form (no served path runs
# chatglm3 with int8 pools: None)
G16_OF = {"paged_decode_partials_g16": "paged_decode_attention",
          "paged_decode_attention_g16": "paged_decode_attention",
          "paged_decode_attention_int8_g16": None,
          "decode_attention_g16": "decode_attention"}
# one CUDA kernel (the `ssd` wrapper) serves both TPU SSD kernels: its line
# entries count its launches on the path of the config with that kernel's
# shapes (the TPU runs ssd_multihead for hymba, ssd for mamba2)
SSD_CONFIG = {"ssd_multihead": "hymba-1.5b", "ssd": "mamba2-2.7b"}


# the partials kernel runs on the served paths as the first pass of the one
# paged route's C entry (csrc/paged_decode.cu), once a route launch; its
# own wrapper serves the kernels phase only.  Line entries with forms:
# (wrapper counted, its forms) — the bf16 entries count the bf16 / fp32
# forms, the int8 entries the int8 ones
FORMS_OF = {
    "fused_matmul": ("fused_matmul", ("fma32", "stream", "wgmma")),
    "fused_matmul_swiglu": ("fused_matmul_swiglu",
                            ("fma32", "stream", "wgmma")),
    "fused_matmul_int8": ("fused_matmul", ("stream_int8", "wgmma_int8")),
    "fused_matmul_swiglu_int8": ("fused_matmul_swiglu",
                                 ("stream_int8", "wgmma_int8")),
    "paged_decode_partials": ("paged_decode_attention", ("bf16", "fp32")),
    "paged_decode_attention": ("paged_decode_attention", ("bf16", "fp32")),
    "paged_decode_partials_int8": ("paged_decode_attention", ("int8",)),
    "paged_decode_attention_int8": ("paged_decode_attention", ("int8",)),
}


def _launches(name, serve):
    if name in GRAD_OF:
        return sum(n[GRAD_OF[name]] for p, n in PATH_LAUNCHES.items()
                   if p.startswith(TRAIN_TAG))
    if name in G16_OF:
        wrapper = G16_OF[name]
        return sum(n[wrapper] for p, n in PATH_LAUNCHES.items()
                   if wrapper and p.startswith(GLM_TAG))
    if name in FORMS_OF:
        wrapper, forms = FORMS_OF[name]
        return sum(TOTAL_BY.get(wrapper, {}).get(t, 0) for t in forms)
    if name not in SSD_CONFIG:
        return TOTAL_LAUNCHES.get(name, 0)
    paths = serve[SSD_CONFIG[name]]["launches"].values()
    return sum(p["ssd"] for p in paths)


def main():
    t_start = time.perf_counter()
    seconds = {}                     # each phase's wall time, in order

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        seconds[key] = time.perf_counter() - t0
        return r

    info = phase_device()
    report = {"device": info, "build": timed("build", phase_build)}
    rows = {}

    def kernels():
        log("kernels vs plain versions (bf16, on the card):")
        for check in (check_gemm, check_swiglu, check_expert_swiglu,
                      check_norms, check_residual_norms, check_ssd,
                      check_flash, check_paged, check_decode_attention,
                      check_gemm_int8, check_paged_int8):
            check(rows)
        return rows

    report["kernels"] = timed("kernels", kernels)
    report["sampling"] = timed("sampling", phase_sampling)
    report["serve"] = timed("serve", phase_serve)
    report["serve_int8"] = timed("serve_int8", phase_serve_int8,
                                 report["serve"])
    report["serve_cli"] = timed("serve_cli", phase_serve_cli)
    report["chunk_prefix"] = timed("chunk_prefix", phase_chunk_prefix)
    report["spec"] = timed("spec", phase_spec)
    report["vit"] = timed("vit", phase_vit, info["nvidia_smi"])
    from repro_torch.configs import GEMMA3_27B, MAMBA2_2_7B
    report["witness"] = timed("witness", lambda: depth_witness(
        MAMBA2_2_7B, layers=8, seed=3))
    report["ring_witness"] = timed("ring_witness", lambda: ring_witness(
        GEMMA3_27B, seed=6))
    report["moe"] = timed("moe", phase_moe)
    report["dense"] = timed("dense", phase_dense)
    report["whisper"] = timed("whisper", phase_whisper)
    report["goodput"] = timed("goodput", phase_goodput)
    report["train"] = timed("train", phase_train, rows, info["nvidia_smi"])
    seconds["total"] = time.perf_counter() - t_start
    report["phase_seconds"] = seconds
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in seconds.items()))
    report["launches_total"] = dict(TOTAL_LAUNCHES)
    report["gemm_templates"] = dict(TEMPLATE_LAUNCHES)
    line = []
    for name, (src, replaces, case) in KERNELS.items():
        r = next(x for x in rows[ROWS_OF.get(name, name)]
                 if x["case"] == case)
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": _launches(name, report["serve"]),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "shape": r["case"]})
        if name in GRAD_OF:
            line[-1].update(backward="torch ops (autograd.Function)",
                            measures="forward + backward")
        if "device_ms" in r:
            line[-1].update(device_ms=r["device_ms"],
                            library_device_ms=r["library_device_ms"],
                            template=r["template"])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                    default=str))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()

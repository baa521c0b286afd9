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
              25 / 5, and over a linear 2048 cache with the window, each
              held to the plain version at the kernel's split count and to
              the TPU kernel's walk); the paged decode's partials at 1, 2
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
              int8` (int8 forms only);
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
              at positions 1010, 1023, 1024 and 1039.
Every driven path zeroes the launch counters just before it and reads them
just after; a kernel of the path that never launched fails the run, and so
does a GEMM that ran the fp32-weight template (fma32) or a flash launch
that ran another template than wgmma on these bf16 paths; in each serve
run every GEMM of the layers (the plain `pdot` products included) must run
the wgmma template once a prefill pass and the stream template once a
decode step, launch for launch.  The
line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
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
    return out + _vit_gemm_cases()


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
    before), at decode batch and a 512-token prefill.  Library yardstick:
    one torch.matmul against the two weights side by side, no prologue."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(4)
    cases = [("M=4 rmsnorm", 4, 3072, 8192, "rmsnorm"),
             ("M=512 rmsnorm", 512, 3072, 8192, "rmsnorm"),
             ("M=4 no norm", 4, 3072, 8192, "none")]
    cases += [(f"M={M} rmsnorm", M, 3072, 8192, "rmsnorm")
              for M in (9, 17, 1100)]
    cases += [(f"hymba M={M}", M, 1600, 5504, "none") for M in (4, 512)]
    rows["fused_matmul_swiglu"] = [
        _gemm_row("fused_matmul_swiglu", label, M, K, N, norm, "none", False,
                  torch.bfloat16, gated=True, g=g)
        for label, M, K, N, norm in cases]


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
# L / H widths; the final norm of the cls rows), and GPT3-XL's encode
# pooling norm (a `last` batch's rows, a `mean` batch's 256-token bucket)
LAYERNORM_SHAPES = ((1576, 768), (1576, 1024), (1576, 1280), (8, 1280),
                    (2, 2048), (256, 2048))
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


def check_norm_paths(g):
    """Each NORM_PATHS case through both norm wrappers against the plain
    version: the dtype pairs the timed rows do not take, and rows that fit
    no register tile (the looped path of the same kernel)."""
    from repro_torch.kernels import rmsnorm as nm
    dev = torch.device(DEVICE)
    results = []
    for label, R, D, xdt, gdt, off in NORM_PATHS:
        gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bet = (0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        buf = torch.randn((off + R * D,), generator=g, device=dev) * 2 + 0.3
        x = buf.to(xdt)[off:].view(R, D)
        for name, got, want in (
                ("rmsnorm", nm.rmsnorm(x, gam, eps=1e-6),
                 nm.rmsnorm_plain(x, gam, eps=1e-6)),
                ("layernorm", nm.layernorm(x, gam, bet, eps=1e-5),
                 nm.layernorm_plain(x, gam, bet, eps=1e-5))):
            err, rel = rel_err(got, want)
            log(f"  {name:9s} {label:40s} rel err {rel:.2e} (tol "
                f"{NORM_TOL:.0e})")
            if not rel <= NORM_TOL:
                raise AssertionError(f"{name} {label}: rel err {rel} > "
                                     f"{NORM_TOL}")
            results.append(dict(name=name, case=label, max_abs_err=err,
                                rel_err=rel, tol=NORM_TOL))
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
    looped path of the same kernel)."""
    from repro_torch.kernels import rmsnorm as nm
    dev = torch.device(DEVICE)
    results = []
    for label, R, D, xdt, ydt, gdt, off in RES_NORM_PATHS:
        gam = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bet = (0.1 * torch.randn((D,), generator=g, device=dev)).to(gdt)
        bufs = [torch.randn((off + R * D,), generator=g, device=dev)
                * s + 0.3 * s for s in (2, 1)]
        x = bufs[0].to(xdt)[off:].view(R, D)
        y = bufs[1].to(ydt)[off:].view(R, D)
        for name, got, want in (
                ("residual_rmsnorm", nm.residual_rmsnorm(x, y, gam, eps=1e-6),
                 nm.residual_rmsnorm_plain(x, y, gam, eps=1e-6)),
                ("residual_layernorm",
                 nm.residual_layernorm(x, y, gam, bet, eps=1e-5),
                 nm.residual_layernorm_plain(x, y, gam, bet, eps=1e-5))):
            err, rel = rel_err(got[0], want[0])
            same_r = torch.equal(got[1], want[1])
            log(f"  {name:18s} {label:42s} rel err h {rel:.2e} (tol "
                f"{NORM_TOL:.0e}), r {'bit-equal' if same_r else 'DIFFERS'}")
            if not (rel <= NORM_TOL and same_r):
                raise AssertionError(f"{name} {label}: rel err {rel}, r "
                                     f"bit-equal {same_r}")
            results.append(dict(name=name, case=label, max_abs_err=err,
                                rel_err=rel, tol=NORM_TOL))
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


FLASH_CASES = (   # label, S, H, KV, D, window, causal, q_offset
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
)


def check_flash(rows):
    """Prefill attention at GPT-J / GPT3-XL / phi4-mini / hymba shapes
    (causal), ViT-B's and ViT-H's (D = 80) bidirectional encoders, also
    D = 80 at 257 tokens (a 1-row tail past four 64-row tiles), a
    causal chunk whose queries start 37 positions into the keys, and
    gemma3's local layers: window 1024 over an 1100-token prompt.  Every
    bf16 case must plan the wgmma template.  Yardstick: SDPA, causal or
    not, or with the window or the offset as a boolean mask; device times
    of the kernel and of SDPA from torch.profiler kernel events."""
    from repro_torch.kernels import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(2)
    results = []
    for label, S, H, KV, D, win, causal, qo in FLASH_CASES:
        Skv = S + qo
        q = torch.randn((1, S, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((1, Skv, KV, D), generator=g, device=dev
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
            pairs = S * (S + 1) // 2 if causal else S * S
        r = _row(label, err, rel, ATTN_TOL, ms, plain, time_ms(lib_fn),
                 2 * (S * H + Skv * KV) * D * 2, 4 * H * D * pairs)
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
PAGED_CASES = (   # H, KV, D, lengths
    (16, 16, 256, (1, 137, 300, 512)),
    (24, 8, 128, (1, 137, 300, 512)),
    (16, 16, 256, GPTJ_SERVE_LENS),
    # 17 slots of 16 kv heads fill the card's SMs twice over: the
    # normalized wrapper runs one split (`paged_splits` == 1)
    (16, 16, 256, (1, 137, 300, 512, 17, 33, 64, 65, 96, 128, 160, 200,
                   250, 290, 332, 400, 480)),
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
    """The paged decode kernel at GPT-J's and phi4-mini's widths over a
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
                    (24, 8, 128, (1, 137, 300, 512)))


def check_paged_int8(rows):
    """The paged decode's int8-pool form (`PAGED_INT8_CASES`): pools
    quantized per (block, kv head) as the cache scatters write them, the
    partials kernel at 1, 2 and 4 splits of the table (merged, and each
    split's m / l) and the normalized wrapper, each held row by row to the
    plain int8 fold at the same split.  Yardstick: bf16 SDPA over dense
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
    plain split grid and to the single pass."""
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device(DEVICE)
    results = []
    for BS, dtype in PAGED_FOLDS:
        q, kp, vp, tab, lengths, _ = _paged_inputs(g, dev, 24, 8, 128,
                                                   BS=BS, dtype=dtype)
        po, _, pl = fd.paged_decode_plain(q, kp, vp, tab, lengths)
        one = po / pl.clamp(min=1e-30)[..., None]
        for S in (1, 2):
            o, m, l = fd.paged_decode_partials(q, kp, vp, tab, lengths, S)
            so, sm, sl = fd.paged_decode_plain(q, kp, vp, tab, lengths, S)
            if S == 1:
                o, m, l, so, sm, sl = (t[None] for t in (o, m, l, so, sm, sl))
            live = sl > 0
            if not torch.equal(l > 0, live):
                raise AssertionError(f"paged_decode_partials BS={BS} "
                                     f"{dtype} splits {S}: live ranges "
                                     f"differ from the plain grid")
            merged = fd.paged_decode_merge_plain(o, m, l,
                                                 out_dtype=torch.float32)
            rel = max(row_rel_err(merged, fd.paged_decode_merge_plain(
                so, sm, sl, out_dtype=torch.float32))[1],
                row_rel_err(merged, one)[1],
                rel_err(m[live], sm[live])[1], rel_err(l[live], sl[live])[1])
            results.append(dict(name="paged_decode_partials", bs=BS,
                                dtype=str(dtype), splits=S, rel_err=rel))
        got = fd.paged_decode_attention(q, kp, vp, tab, lengths)
        results.append(dict(name="paged_decode_attention", bs=BS,
                            dtype=str(dtype), rel_err=row_rel_err(
                                got, one.to(dtype))[1]))
    for r in results:
        label = (f"{r['name']} BS={r['bs']} {r['dtype']}"
                 + (f" splits {r['splits']}" if "splits" in r else ""))
        log(f"  {label:50s} rel err {r['rel_err']:.2e} (tol {ATTN_TOL:.0e})")
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
)


def check_decode_attention(rows):
    """The dense decode kernel on gemma3's and hymba's ring caches (the
    valid slots are a prefix of the ring) and on a linear cache with
    gemma3's window (in bf16, and in fp32), each batch row held to its own scale against the
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
GEMM_WRAPPERS = ("fused_matmul", "fused_matmul_swiglu")
PAGED_WRAPPERS = ("paged_decode_attention", "paged_decode_partials")
# wrappers with launches_by: the GEMMs by template and weight form, flash
# by template, the paged decode by pool dtype
TEMPLATED = GEMM_WRAPPERS + ("flash_attention",) + PAGED_WRAPPERS
GEMM_KERNELS = ("stream_kernel", "splitk_finish", "wgmma_kernel",
                "fused_mm_kernel", "fused_swiglu_kernel")
TEMPLATE_LAUNCHES = {}         # path -> wrapper -> template -> launches


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


def gemms_per_pass(cfg):
    """(fused GEMMs, gated GEMMs) the layers of `cfg` launch in one pass of
    the fused chain: q / k / v / o per attention layer, the five SSM
    projections (x, z, B|C, dt, out: `pdot`, the hand GEMM with no
    prologue) per SSM layer, and per MLP the down-projection plus the
    up-projection (gated for SwiGLU); pure SSM layers have no MLP."""
    from repro_torch.configs.base import ATTN_KINDS
    fused = gated = 0
    for kind, count in cfg.schedule:
        if kind in ATTN_KINDS:
            fused += 4 * count
        if kind in ("ssm", "hybrid_attn", "hybrid_local"):
            fused += 5 * count
        if kind != "ssm":
            swiglu = cfg.mlp_act == "swiglu"
            fused += (1 if swiglu else 2) * count
            gated += (1 if swiglu else 0) * count
    return fused, gated


def check_gemm_templates(cfg, st, by, *, int8=False):
    """Prefill GEMMs run the wgmma template and decode GEMMs the stream
    template: each GEMM of the layers (`gemms_per_pass`, the plain `pdot`
    products included) launches wgmma once a prefill pass and stream once
    a decode step; the logits head (M = the pass's sequences, <= 4)
    streams in both.  An encode batch runs the layers' GEMMs once at M =
    its tasks x its bucket rows, which the served encodes keep above 8
    (wgmma), and no head.  `int8`: every one of them runs the template's
    int8-weight form, and no bf16 form launches at all (no int8 weight is
    widened to a bf16 copy)."""
    P, D, E = st.prefill_batches, st.decode_steps, st.encode_batches
    mm, sw = by["fused_matmul"], by["fused_matmul_swiglu"]
    per_layer, per_swiglu = gemms_per_pass(cfg)
    sfx = "_int8" if int8 else ""
    want = {"fused_matmul": {"stream" + sfx: P + D * (per_layer + 1),
                             "wgmma" + sfx: (P + E) * per_layer},
            "fused_matmul_swiglu": {"stream" + sfx: D * per_swiglu,
                                    "wgmma" + sfx: (P + E) * per_swiglu}}
    for forms in want.values():
        for t in ("fma32", "stream", "wgmma", "stream_int8", "wgmma_int8"):
            forms.setdefault(t, 0)
    got = {k: by[k] for k in GEMM_WRAPPERS}
    log(f"  [{cfg.name} serve] GEMM templates: {per_layer} fused GEMMs and "
        f"{per_swiglu} gated GEMMs of the layers per pass, {P} prefill and "
        f"{E} encode passes; launches {got}, expected {want} (observed "
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
                   max_seq=512):
    """Final-position logits [1, vocab] fp32 of one prompt through the
    prefill stack and the logits head, fused or unfused chain, under a
    kernel mode and a precision policy (default bf16)."""
    from repro_torch.core.precision import BF16
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    policy = policy or BF16
    with ops.kernel_mode(mode), torch.no_grad():
        x = lm._embed_sequence(params, prompt, policy=policy)
        x, _ = lm._run_segments_prefill(params, x, cfg=cfg, policy=policy,
                                        max_seq=max_seq, fused=fused,
                                        compact_kv=True)
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
        if ring_layers(cfg, max_seq):
            need.add("decode_attention")
    if cfg.mlp_act == "swiglu" and kinds - {"ssm"}:
        need.add("fused_matmul_swiglu")
    if cfg.has_ssm:
        need |= {"ssd", "rmsnorm"}               # SSM and hybrid ln1
    if hybrid and path != "unfused":
        need.add("residual_rmsnorm")             # the hybrid ln2
    if path == "unfused" or encode:
        need.add(cfg.norm)
    return tuple(sorted(need))


def check_serve_counts(cfg, launches, st, max_seq, by=None, kv_int8=False):
    """The dense decode kernel runs once per ring layer per decode step and
    never in prefill, the paged route once per paged layer per decode step
    (its own wrappers for the partials and the merge never), every one of
    those launches in the int8-pool form when `kv_int8` and in the bf16
    form otherwise (`by`: the path's launches by form); flash once per
    attention layer per prefill or encode pass; the SSD kernel once per
    SSM layer per prefill pass, the residual RMSNorm once per hybrid layer
    per prefill pass and decode step; in a LayerNorm config the plain
    LayerNorm only as an encode batch's pooling norm, once a batch (the
    fused engine folds every other norm into a GEMM)."""
    from repro_torch.configs.base import ATTN_KINDS
    attn_layers = sum(c for k, c in cfg.schedule if k in ATTN_KINDS)
    rings = ring_layers(cfg, max_seq)
    want = {"decode_attention": rings * st.decode_steps,
            "paged_decode_attention": (attn_layers - rings) * st.decode_steps,
            "paged_decode_partials": 0, "paged_decode_merge": 0,
            "flash_attention": attn_layers * (st.prefill_batches
                                              + st.encode_batches)}
    if cfg.norm == "layernorm":
        want["layernorm"] = st.encode_batches
    if cfg.has_ssm:
        ssm_layers = sum(c for k, c in cfg.schedule
                         if k in ("ssm", "hybrid_attn", "hybrid_local"))
        hybrid_layers = sum(c for k, c in cfg.schedule
                            if k in ("hybrid_attn", "hybrid_local"))
        want.update(ssd=ssm_layers * st.prefill_batches,
                    residual_rmsnorm=hybrid_layers * (st.prefill_batches
                                                      + st.decode_steps))
    got = {k: launches[k] for k in want}
    if by is not None:
        paged = want["paged_decode_attention"]
        want["paged_decode_attention by form"] = {
            "bf16": 0 if kv_int8 else paged, "fp32": 0,
            "int8": paged if kv_int8 else 0}
        got["paged_decode_attention by form"] = by["paged_decode_attention"]
    log(f"  [{cfg.name} serve] {st.prefill_batches} prefill passes, "
        f"{st.encode_batches} encode passes, {st.decode_steps} decode "
        f"steps: launches {got}, expected {want}")
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


def _gated_kernel(name):
    """Whether a GEMM kernel of a profile is the gated (SwiGLU) one: its
    GATED template argument (stream_kernel<MT, GATED, I8>,
    wgmma_kernel<GATED, I8>, splitk_finish<GATED>) or the fp32 template's
    own kernel."""
    if "fused_swiglu_kernel" in name:
        return True
    m = re.search(r"(stream_kernel|wgmma_kernel|splitk_finish)<([^>]*)>",
                  name)
    if m is None:
        return False
    args = [a.strip() for a in m.group(2).split(",")]
    return args[1 if m.group(1) == "stream_kernel" else 0] == "true"


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
    gemm = {"fused_matmul": [0.0, 0], "fused_matmul_swiglu": [0.0, 0]}
    for name, (ms, n) in dev.items():
        if any(k in name for k in GEMM_KERNELS):
            key = ("fused_matmul_swiglu" if _gated_kernel(name)
                   else "fused_matmul")
            gemm[key][0] += ms
            gemm[key][1] += n
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]

    def _share(pred):
        hits = [v for k, v in dev.items() if pred(k)]
        return (sum(ms for ms, _ in hits), sum(n for _, n in hits))

    # the decode kernels and their merges, the norm kernels; library GEMMs
    # (cuBLAS / CUTLASS: none of the port's projections should reach one);
    # copies and casts
    shares = {
        "paged_decode": _share(lambda k: "paged_decode_kernel" in k),
        "decode_attention": _share(lambda k: "decode_attention_kernel" in k),
        # the merge kernel of both decode kernels (decode_fold.cuh)
        "decode_merge": _share(lambda k: "dec_merge_kernel" in k),
        "norm": _share(lambda k: re.search(r"(?<!res_)norm_kernel", k)
                       is not None),
        "residual_norm": _share(lambda k: "res_norm_kernel" in k),
        "library_gemm": _share(lambda k: re.search(
            r"gemm|gemv|xmma|cutlass", k, re.I) is not None and not any(
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
    `auto` mode), once to warm up, once timed on the host clock, then once
    under torch.profiler (`device_kernels`).  Reports the device's busy time (kernel time)
    against the pass, the device events, the SSD kernels' share (every
    kernel of `csrc/ssd.cu`), the GEMM templates' share and the largest
    kernels."""
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, prompt_len),
                                       dtype=np.int32), device=DEVICE)
    run = lambda: teacher_forced(cfg, params, prompt, mode="auto",
                                 fused=True, max_seq=max_seq)
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
    from repro_torch.models import lm
    out = {}
    for t in tasks:
        tok = torch.tensor(np.asarray(t.prompt)[None], device=DEVICE)
        with ops.kernel_mode("ref"), torch.no_grad():
            z_ref, z_fp32 = (lm.forward_encode(params, tok, cfg=cfg,
                                               policy=pol, pooling=t.pooling)
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


def serve_model(cfg, *, seed, max_seq=512, lengths=SERVE_LENGTHS,
                prefill_profile=False, encodes=(), weight_dtype="bfloat16",
                kv_dtype=None):
    """Serve len(lengths) requests of 32 new tokens (uids 1 and 6 sampled)
    through InferenceEngine at full width, the EncodeTasks `encodes`
    ((pooling, length) pairs, uids 100 + i) interleaved with the first of
    them, then profile decode steps (and, `prefill_profile`, one prefill
    pass of max_seq tokens) and teacher-force one prompt through the fused
    kernel path, the unfused kernel path and the plain path.  The engine
    captures its decode step once, at construction; every decode step of
    the run must be a replay of that one graph, and the first profile
    holds a replay to the eager step (`check_graph_vs_eager`).
    `weight_dtype` / `kv_dtype`: the engine's int8 knobs; with int8
    weights the teacher-forced paths run on the engine's quantized
    weights, and every GEMM launch must be an int8 form (with int8 KV,
    every paged launch)."""
    from repro_torch.core.precision import BF16, FP32
    from repro_torch.models import lm
    from repro_torch.serving import (EncodeTask, InferenceEngine, Request,
                                     SamplingParams)

    t0 = time.perf_counter()
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device=DEVICE, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    ssm = (f" SSM {cfg.ssm_heads}->{cfg.padded_ssm_heads()} heads x "
           f"{cfg.ssm_head_dim} state {cfg.ssm_state}" if cfg.has_ssm else "")
    log(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff}{ssm} "
        f"{cfg.mlp_act} {cfg.norm} vocab {cfg.vocab}->{cfg.padded_vocab}: "
        f"{n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=max_seq,
                          block_size=16, policy=BF16, device=DEVICE,
                          weight_dtype=weight_dtype, kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    step = eng.runner.decode_step
    tag = (f"{cfg.name} int8" if weight_dtype == "int8" or kv_dtype == "int8"
           else cfg.name)
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
                       kv_int8=st.kv_dtype == "int8")
    check_gemm_templates(cfg, st, TEMPLATE_LAUNCHES[f"{tag} serve"],
                         int8=weight_dtype == "int8")
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
    served = eng.runner.params       # the engine's weights (int8: quantized)
    del eng
    torch.cuda.empty_cache()
    if encodes:
        report["encode"] = check_encodes(cfg, params, enc_tasks, max_seq)
    if prefill_profile:
        report["prefill_profile"] = profile_prefill(
            cfg, params, np.random.default_rng(1), prompt_len=max_seq,
            max_seq=max_seq)

    # teacher-forced: one prompt through the two kernel paths, held to the
    # plain bf16 path (`ref` mode) and the plain fp32 path; the gap between
    # those two is the rounding floor the gates scale with
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 96),
                                       dtype=np.int32), device=DEVICE)
    z_ref = teacher_forced(cfg, served, prompt, mode="ref", fused=True,
                           max_seq=max_seq)
    z_fp32 = teacher_forced(cfg, served, prompt, mode="ref", fused=True,
                            policy=FP32, max_seq=max_seq)
    floor = _gap(z_ref, z_fp32)
    log(f"  teacher-forced {tag} plain bf16 vs plain fp32 (floor): rel "
        f"{floor[0]:.2e}, cosine {np.cos(floor[1]):.6f}")
    tf = report["teacher_forced"]
    tf["floor"] = {"rel": floor[0], "cosine": float(np.cos(floor[1]))}
    for path, fused in (("fused", True), ("unfused", False)):
        z, report["launches"][f"teacher_forced_{path}"] = drive(
            f"{tag} teacher-forced {path}",
            lambda: teacher_forced(cfg, served, prompt, mode="auto",
                                   fused=fused, max_seq=max_seq),
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
                                            kv_dtype=kv_dtype)
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
    GEMM and paged launches must all be int8 forms."""
    import contextlib
    import io

    from repro_torch.configs import GPT_J
    from repro_torch.launch import serve
    sampled = SERVE_CLI + ["--temperature", "0.8", "--top-k", "40"]
    runs = {"generate": (sampled, path_kernels(GPT_J, "serve", max_seq=256),
                         "decode step captured"),
            "int8": (sampled + ["--weight-dtype", "int8", "--kv-dtype",
                                "int8"],
                     path_kernels(GPT_J, "serve", max_seq=256),
                     "QUANT w=int8 kv=int8"),
            "encode": (SERVE_CLI + ["--task", "encode", "--pooling", "last"],
                       ("flash_attention", "fused_matmul", "layernorm"),
                       "ENC")}
    out = {}
    for task, (argv, need, marker) in runs.items():
        buf = io.StringIO()

        def main():
            with contextlib.redirect_stdout(buf):
                return serve.main(argv)
        t0 = time.perf_counter()
        rc, launches = drive(f"serve CLI gpt-j {task}", main, need)
        seconds = time.perf_counter() - t0
        text = buf.getvalue()
        log(f"serve CLI ({task}): python -m repro_torch.launch.serve "
            f"{' '.join(argv)}: exit {rc} in {seconds:.1f} s")
        for line in text.splitlines():
            log(f"  | {line}")
        if rc != 0 or "served 6 requests" not in text or marker not in text:
            raise AssertionError(f"serve CLI ({task}) did not serve its "
                                 f"trace")
        by = TEMPLATE_LAUNCHES[f"serve CLI gpt-j {task}"]
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
                  max_seq, block_size=16, kv_dtype=None):
    """Teacher-forced decode logits [steps, vocab] fp32 of one sequence:
    `tokens[:prompt_len]` prefilled into the engine's decode caches
    (`cache_layout` / `prefill_scatter`, paged global layers, ring local
    ones; `kv_dtype="int8"`: int8 pools quantized on write), then one step
    per remaining token through the decode stack that `forward_decode`
    runs, and the logits head."""
    from repro_torch.core.embedding import embed_token
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
        x = lm._embed_sequence(params, tok[None, :prompt_len], policy=policy)
        _, group = lm._run_segments_prefill(
            params, x, cfg=cfg, policy=policy, max_seq=max_seq, fused=fused,
            compact_kv=True)
        prefill_scatter(caches, group, torch.zeros(1, dtype=torch.int64,
                                                   device=dev), table,
                        block_size=block_size,
                        paged_segments=layout.segments)
        del group
        for pos in range(prompt_len, len(tokens)):
            xd = embed_token(params["embedding"]["embed"], tok[pos:pos + 1],
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
                       max_seq=512):
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
        counted beside them, against the same control."""
    from repro_torch.core.precision import BF16, FP32
    rng = np.random.default_rng(seed + 50)
    tokens = rng.integers(0, cfg.vocab, prompt_len + steps, dtype=np.int32)
    short = tokens[:prompt_len + gated_steps]
    kw = dict(max_seq=max_seq, fused=True)
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
}
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
    if name in FORMS_OF:
        wrapper, forms = FORMS_OF[name]
        return sum(TOTAL_BY.get(wrapper, {}).get(t, 0) for t in forms)
    if name not in SSD_CONFIG:
        return TOTAL_LAUNCHES.get(name, 0)
    paths = serve[SSD_CONFIG[name]]["launches"].values()
    return sum(p["ssd"] for p in paths)


def main():
    info = phase_device()
    report = {"device": info, "build": phase_build()}
    rows = {}
    log("kernels vs plain versions (bf16, on the card):")
    check_gemm(rows)
    check_swiglu(rows)
    check_norms(rows)
    check_residual_norms(rows)
    check_ssd(rows)
    check_flash(rows)
    check_paged(rows)
    check_decode_attention(rows)
    check_gemm_int8(rows)
    check_paged_int8(rows)
    report["kernels"] = rows
    report["sampling"] = phase_sampling()
    report["serve"] = phase_serve()
    report["serve_int8"] = phase_serve_int8(report["serve"])
    report["serve_cli"] = phase_serve_cli()
    report["vit"] = phase_vit(info["nvidia_smi"])
    from repro_torch.configs import GEMMA3_27B, MAMBA2_2_7B
    report["witness"] = depth_witness(MAMBA2_2_7B, layers=8, seed=3)
    report["ring_witness"] = ring_witness(GEMMA3_27B, seed=6)
    report["launches_total"] = dict(TOTAL_LAUNCHES)
    report["gemm_templates"] = dict(TEMPLATE_LAUNCHES)
    line = []
    for name, (src, replaces, case) in KERNELS.items():
        r = next(x for x in rows[name] if x["case"] == case)
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": _launches(name, report["serve"]),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "shape": r["case"]})
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

"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each prints its results; any failure raises and the exit code is
non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch / CUDA /
              nvcc versions;
  2. build    nvcc builds every kernel from src/repro_torch/kernels/csrc;
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, in bf16, at the GPT-J / GPT3-XL serving shapes: the
              error against the stated tolerance, kernel / plain / library
              milliseconds (CUDA events, median of the timed launches) and
              the bound (the larger of bytes / 3.35 TB/s and FLOPs / 989
              TFLOP/s, the H100 SXM data-sheet peaks);
  4. serve    GPT-J at full width and depth (random seeded weights) behind
              InferenceEngine(batch_size=4, max_seq=512, block_size=16): 8
              requests, every kernel's launch counter > 0, no leaked blocks;
              then one prompt teacher-forced through the kernel path and
              the plain path, final-position logits compared.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
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
LOGIT_TOL = 5e-2              # teacher-forced head: max|dz| / max|z|
LOGIT_COS = 0.999


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


def rel_err(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


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
    """(label, M, K, N, norm, activation, residual, out dtype) — the GPT-J
    projections at decode batch (M=4) and a 512-token prefill."""
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
    return out


def check_gemm(rows):
    from repro_torch.kernels import matmul as mm
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(1)
    results = []
    for label, M, K, N, norm, act, has_res, od in _gemm_cases():
        a = torch.randn((M, K), generator=g, device=dev).bfloat16()
        w = (torch.randn((K, N), generator=g, device=dev) * 0.02).bfloat16()
        gam = (1 + 0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16()
        bet = (0.1 * torch.randn((K,), generator=g, device=dev)).bfloat16()
        res = (torch.randn((M, N), generator=g, device=dev).bfloat16()
               if has_res else None)
        kw = dict(norm=norm, activation=act, residual=res, out_dtype=od,
                  eps=1e-5)
        if norm != "none":
            kw.update(gamma=gam, nbeta=bet)
        got = mm.fused_matmul(a, w, **kw)
        torch.cuda.synchronize()
        want = mm.matmul_plain(a, w, **kw)
        err, rel = rel_err(got, want)
        tol = GEMM_TOL["fp32" if od == torch.float32 else "bf16"]
        ms = time_ms(lambda: mm.fused_matmul(a, w, **kw))
        plain = time_ms(lambda: mm.matmul_plain(a, w, **kw), iters=5)
        lib = time_ms(lambda: torch.matmul(a, w), iters=10)
        nbytes = (M * K + K * N) * 2 + M * N * (4 if od == torch.float32
                                                else 2)
        nbytes += (M * N * 2 if has_res else 0) + (2 * K * 2 if norm != "none"
                                                   else 0)
        b_ms, b_by = bound_ms(nbytes, 2 * M * N * K)
        r = dict(case=label, max_abs_err=err, rel_err=rel, tol=tol, ms=ms,
                 plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        log(f"  fused_matmul {label:14s} rel err {rel:.2e} (tol {tol:.0e}) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms torch.matmul "
            f"{lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not rel <= tol:
            raise AssertionError(f"fused_matmul {label}: rel err {rel} > {tol}")
        results.append(r)
    rows["fused_matmul"] = results


def check_flash(rows):
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(2)
    results = []
    for label, H, D in (("gpt-j S=512 D=256", 16, 256),
                        ("gpt3-xl S=512 D=128", 16, 128)):
        S = 512
        q, k, v = (torch.randn((1, S, H, D), generator=g, device=dev
                               ).bfloat16() for _ in range(3))
        got = fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=True)
        err, rel = rel_err(got, want)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                         causal=True),
                        iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4 * H * D * S * (S + 1) // 2
        b_ms, b_by = bound_ms(4 * S * H * D * 2, flops)
        log(f"  flash_attention {label:20s} rel err {rel:.2e} (tol "
            f"{ATTN_TOL:.0e}) kernel {ms:.4f} ms plain {plain:.4f} ms sdpa "
            f"{lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not rel <= ATTN_TOL:
            raise AssertionError(f"flash_attention {label}: rel err {rel}")
        results.append(dict(case=label, max_abs_err=err, rel_err=rel,
                            tol=ATTN_TOL, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b_ms, bound_by=b_by))
    rows["flash_attention"] = results


def _paged_inputs(g, dev):
    """GPT-J decode batch: 4 slots, 16 heads x 256, 16-token blocks,
    lengths 1..512 with absent table entries."""
    B, H, D, BS, MB = 4, 16, 256, 16, 32
    NB = B * MB + 8
    lengths = torch.tensor([1, 137, 300, 512], dtype=torch.int32, device=dev)
    perm = torch.randperm(NB, generator=g, device=dev)[:B * MB]
    tab = perm.reshape(B, MB).to(torch.int32)
    for b in range(B):
        tab[b, -(-int(lengths[b]) // BS):] = -1
    tab[2, 5] = -1                                  # a hole inside slot 2
    q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
    kp = torch.randn((NB, BS, H, D), generator=g, device=dev).bfloat16()
    vp = torch.randn((NB, BS, H, D), generator=g, device=dev).bfloat16()
    live = sum(max(0, min(BS, int(lengths[b]) - e * BS))
               for b in range(B) for e in range(MB) if int(tab[b, e]) >= 0)
    return q, kp, vp, tab, lengths, live


def _dense_from_paged(q, kp, vp, tab, lengths):
    """Dense [B, H, S, D] copies + mask for the SDPA yardstick."""
    B, MB = tab.shape
    BS = kp.shape[1]
    safe = tab.clamp(min=0).long()
    k = kp[safe].reshape(B, MB * BS, *kp.shape[2:]).transpose(1, 2)
    v = vp[safe].reshape(B, MB * BS, *vp.shape[2:]).transpose(1, 2)
    pos = torch.arange(MB * BS, device=q.device)
    ok = (pos[None] < lengths[:, None]) & (tab >= 0).repeat_interleave(BS, 1)
    return q[:, :, None], k.contiguous(), v.contiguous(), ok[:, None, None]


def check_paged(rows):
    from repro_torch.kernels import flash_decode as fd
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(3)
    q, kp, vp, tab, lengths, live = _paged_inputs(g, dev)
    B, H, D = q.shape
    dq, dk, dv, mask = _dense_from_paged(q, kp, vp, tab, lengths)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        dq, dk, dv, attn_mask=mask))
    flops = 4 * H * D * live
    nbytes = q.numel() * 2 + 2 * live * H * D * 2
    o, m, l = fd.paged_decode_partials(q, kp, vp, tab, lengths)
    out = fd.paged_decode_attention(q, kp, vp, tab, lengths)
    torch.cuda.synchronize()
    po, pm, pl = fd.paged_decode_plain(q, kp, vp, tab, lengths)
    pout = (po / pl.clamp(min=1e-30)[..., None]).bfloat16()
    results = {}
    for name, fn, got, want, out_bytes in (
            ("paged_decode_partials",
             lambda: fd.paged_decode_partials(q, kp, vp, tab, lengths),
             o / l[..., None], po / pl[..., None], B * H * (D + 2) * 4),
            ("paged_decode_attention",
             lambda: fd.paged_decode_attention(q, kp, vp, tab, lengths),
             out, pout, B * H * D * 2)):
        err, rel = rel_err(got, want)
        if name == "paged_decode_partials":
            # the statistics themselves, not only their ratio
            for a, b in ((m, pm), (l, pl)):
                rel = max(rel, rel_err(a, b)[1])
        ms = time_ms(fn)
        plain = time_ms(lambda: fd.paged_decode_plain(q, kp, vp, tab,
                                                      lengths), iters=5)
        b_ms, b_by = bound_ms(nbytes + out_bytes, flops)
        log(f"  {name:23s} B=4 H=16 D=256 len 1/137/300/512 rel err "
            f"{rel:.2e} (tol {ATTN_TOL:.0e}) kernel {ms:.4f} ms plain "
            f"{plain:.4f} ms sdpa {lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        if not rel <= ATTN_TOL:
            raise AssertionError(f"{name}: rel err {rel}")
        results[name] = [dict(case="B=4 H=16 D=256 BS=16 len 1/137/300/512",
                              max_abs_err=err, rel_err=rel, tol=ATTN_TOL,
                              ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by)]
    rows.update(results)


# --------------------------------------------------------------------------
# 4. serve GPT-J end to end
# --------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import matmul as mm
    return {"fused_matmul": mm.fused_matmul,
            "flash_attention": fa.flash_attention,
            "paged_decode_partials": fd.paged_decode_partials,
            "paged_decode_attention": fd.paged_decode_attention}


def phase_serve():
    from repro_torch.configs import GPT_J
    from repro_torch.core.embedding import logits_local
    from repro_torch.core.precision import BF16
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serving import InferenceEngine, Request, SamplingParams

    cfg = GPT_J
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: GPT-J {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}x{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab}->"
        f"{cfg.padded_vocab}: {n_params / 1e9:.3f} B params, init "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                          block_size=16, policy=BF16)
    rng = np.random.default_rng(0)
    # first wave reaches 332 positions (split-KV partials), the second stays
    # under 256 (one normalized pass): both decode kernels serve traffic
    lengths = (300, 40, 120, 60, 20, 90, 200, 150)
    sampled = {1, 6}
    for uid, n in enumerate(lengths):
        sp = (SamplingParams(temperature=0.8, top_k=40, seed=100 + uid)
              if uid in sampled else SamplingParams())
        eng.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, n, dtype=np.int32), max_new_tokens=32, sampling=sp))
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    st = eng.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve: {len(done)} requests in {wall:.2f} s | NAR "
        f"{st.nar_tok_s:.1f} tok/s | AR {st.ar_tok_s:.1f} tok/s | TTFT p50 "
        f"{st.ttft_p50_ms:.1f} ms | decode step p50 "
        f"{st.decode_step_p50_ms:.2f} ms p95 {st.decode_step_p95_ms:.2f} ms |"
        f" peak memory {peak_gb:.2f} GB | launches {launches}")
    if len(done) != len(lengths):
        raise AssertionError(f"{len(done)} of {len(lengths)} finished")
    for r in done:
        if len(r.output) != 32:
            raise AssertionError(f"request {r.uid}: {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of vocab")
    if eng.allocator.num_free != eng.allocator.num_blocks:
        raise AssertionError("KV blocks leaked")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched while serving: "
                             f"{missing}")

    # teacher-forced: one prompt through the kernel path and the plain path
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 96),
                                       dtype=np.int32), device=DEVICE)
    zs = {}
    for mode in ("auto", "ref"):
        with ops.kernel_mode(mode), torch.no_grad():
            x = lm._embed_sequence(params, prompt, policy=BF16)
            x, _ = lm._run_segments_prefill(params, x, cfg=cfg, policy=BF16,
                                            max_seq=512, compact_kv=True)
            zs[mode] = logits_local(
                x[:, -1], params["embedding"]["unemb"], cfg=cfg, policy=BF16,
                norm=ops.norm_prologue(params["final_norm"], cfg.norm)
            )[:, :cfg.vocab].float()
    err, rel = rel_err(zs["auto"], zs["ref"])
    cos = torch.nn.functional.cosine_similarity(zs["auto"], zs["ref"]).item()
    finite = bool(torch.isfinite(zs["auto"]).all())
    log(f"teacher-forced 96-token prompt, final-position logits kernel vs "
        f"plain: max abs {err:.4f}, rel {rel:.2e} (tol {LOGIT_TOL:.0e}), "
        f"cosine {cos:.6f} (min {LOGIT_COS}), argmax "
        f"{int(zs['auto'].argmax())} vs {int(zs['ref'].argmax())}")
    if not (finite and rel <= LOGIT_TOL and cos >= LOGIT_COS):
        raise AssertionError("teacher-forced logits disagree")
    return {"launches": launches, "stats": st.to_dict(), "wall_s": wall,
            "peak_memory_gb": peak_gb, "params": n_params,
            "teacher_forced": {"max_abs": err, "rel": rel, "cosine": cos}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


KERNELS = {
    "fused_matmul": ("src/repro_torch/kernels/csrc/fused_matmul.cu",
                     "src/repro/kernels/matmul.py:161", "mlp_up M=4"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:94",
                        "gpt-j S=512 D=256"),
    "paged_decode_partials": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                              "src/repro/kernels/flash_decode.py:321", None),
    "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                               "src/repro/kernels/flash_decode.py:297", None),
}


def main():
    info = phase_device()
    report = {"device": info, "build": phase_build()}
    rows = {}
    log("kernels vs plain versions (bf16, on the card):")
    check_gemm(rows)
    check_flash(rows)
    check_paged(rows)
    report["kernels"] = rows
    report["serve"] = phase_serve()
    line = []
    for name, (src, replaces, case) in KERNELS.items():
        rs = rows[name]
        r = next(x for x in rs if case is None or x["case"] == case)
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": report["serve"]["launches"][name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "shape": r["case"]})
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

"""Probe the fused GEMMs' templates on one NVIDIA GPU, in about a minute.

    python3 gemm_probe.py

Builds `csrc/fused_matmul.cu` and `csrc/fused_swiglu.cu` (printing ptxas'
register and spill lines), then runs each template the planner picks
(stream at M <= 8, wgmma above, K split or not) with every norm against its
plain version, and times the served shapes: device time of the kernel and
of one `torch.matmul` over the same weights (torch.profiler kernel events,
no host time), decode shapes rotating weight copies past the 50 MB L2,
beside the byte / FLOP bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s).  A case
off its tolerance (max|k - p| / max|p|: 1e-2 bf16, 1e-3 fp32) fails the
run.  Last, the host cost of one call at a tiny shape (the wrappers'
Python, ctypes and the launches), beside one `torch.matmul`'s.
`chip_smoke.py` is the whole check; this is the quick loop for kernel
work.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-3}
L2_ROTATE_BYTES = 64 << 20


def device_ms(fns, iters=20):
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total", 0.0)
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def host_us(fn, calls=500):
    """Host microseconds a call: `calls` back-to-back calls of a tiny
    product, timed on the host clock to the last one's completion."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def case(g, label, M, K, N, norm, *, act="none", res=False,
         od=torch.bfloat16, gated=False, timed=False):
    """One GEMM call against its plain version; with `timed`, device ms of
    the kernel and of torch.matmul.  Returns False when off tolerance."""
    from repro_torch.kernels import matmul as mm
    dev = "cuda"
    nb = 2 if gated else 1
    copies = 1
    if timed and M <= mm.STREAM_MAX_M:
        copies = max(1, -(-L2_ROTATE_BYTES // (K * N * 2 * nb)))
    a = torch.randn((M, K), generator=g, device=dev).bfloat16()
    ws = [[(torch.randn((K, N), generator=g, device=dev) * 0.02).bfloat16()
           for _ in range(nb)] for _ in range(copies)]
    kw = dict(norm=norm, out_dtype=od,
              eps=1e-5 if norm == "layernorm" else 1e-6)
    if norm != "none":
        kw["gamma"] = (1 + 0.1 * torch.randn((K,), generator=g,
                                             device=dev)).bfloat16()
    if norm == "layernorm":
        kw["nbeta"] = (0.1 * torch.randn((K,), generator=g,
                                         device=dev)).bfloat16()
    if res:
        kw["residual"] = torch.randn((M, N), generator=g,
                                     device=dev).bfloat16()
    if gated:
        fns = [lambda w=w: mm.matmul_swiglu(a, w[0], w[1], **kw) for w in ws]
        want = mm.matmul_swiglu_plain(a, ws[0][0], ws[0][1], **kw)
        wl = [torch.cat(w, 1) for w in ws]
    else:
        kw["activation"] = act
        fns = [lambda w=w: mm.fused_matmul(a, w[0], **kw) for w in ws]
        want = mm.matmul_plain(a, ws[0][0], **kw)
        wl = [w[0] for w in ws]
    plan = mm.gemm_plan(M, K, N, gated=gated)
    got = fns[0]()
    torch.cuda.synchronize()
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    ok = rel <= TOL[od]
    msg = (f"{label:30s} M={M:<5d} {plan.template:6s} splits "
           f"{plan.splits:<3d} rel err {rel:.2e}{'' if ok else ' FAILED'}")
    if timed:
        nbytes = (M * K + nb * K * N) * 2 + M * N * (4 if od == torch.float32
                                                     else 2)
        bound = max(nbytes / 3.35e9, 2 * nb * M * N * K / 989e9)
        lib = [lambda w=w: torch.matmul(a, w) for w in wl]
        msg += (f" | device {device_ms(fns):.4f} ms, torch.matmul "
                f"{device_ms(lib):.4f} ms, bound {bound:.4f} ms, "
                f"{copies} weight copies")
    print(msg, flush=True)
    return ok


def main():
    if not torch.cuda.is_available():
        raise SystemExit("gemm_probe: no CUDA device")
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    t0 = time.perf_counter()
    for r in build.build_all(("fused_matmul", "fused_swiglu")):
        for line in r["log"].splitlines():
            if "registers" in line or ("spill" in line
                                       and " 0 bytes spill stores" not in line):
                print(f"  ptxas[{r['name']}]: {line.strip()}")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    norms = ("none", "rmsnorm", "layernorm")
    for M in (1, 4, 8, 9, 17, 200):           # every template, every norm
        for norm in norms:
            ok &= case(g, f"[{M}, 4096] @ [4096, 4096] {norm}", M, 4096, 4096,
                       norm, res=norm == "none")
            ok &= case(g, f"gated [{M}, 3072] @ 2 x 8192 {norm}", M, 3072,
                       8192, norm, gated=True)
    for label, M, K, N, norm, kw in (
            ("GPT-J mlp_up", 4, 4096, 16384, "layernorm", dict(act="i_gelu")),
            ("GPT-J mlp_up", 512, 4096, 16384, "layernorm",
             dict(act="i_gelu")),
            ("GPT-J qkv", 512, 4096, 4096, "layernorm", {}),
            ("GPT-J head fp32", 512, 4096, 50432, "layernorm",
             dict(od=torch.float32)),
            ("phi4 k/v", 4, 3072, 1024, "rmsnorm", {}),
            ("phi4 head fp32", 4, 3072, 200192, "rmsnorm",
             dict(od=torch.float32)),
            ("gemma3 up", 4, 5376, 21504, "rmsnorm", dict(act="i_gelu")),
            ("gemma3 down", 4, 21504, 5376, "none", dict(res=True)),
            ("gemma3 q", 9, 5376, 4096, "rmsnorm", {}),
            ("gemma3 q", 1100, 5376, 4096, "rmsnorm", {}),
            ("hymba w2", 512, 5504, 1600, "none", dict(res=True)),
            ("phi4 SwiGLU", 4, 3072, 8192, "rmsnorm", dict(gated=True)),
            ("phi4 SwiGLU", 512, 3072, 8192, "rmsnorm", dict(gated=True)),
            ("hymba SwiGLU", 4, 1600, 5504, "none", dict(gated=True))):
        ok &= case(g, label, M, K, N, norm, timed=True, **kw)
    from repro_torch.kernels import matmul as mm
    for M in (4, 64):                         # stream, wgmma
        a = torch.randn((M, 512), generator=g, device="cuda").bfloat16()
        w = torch.randn((512, 512), generator=g, device="cuda").bfloat16()
        gam = torch.ones(512, device="cuda").bfloat16()
        res = torch.randn((M, 512), generator=g, device="cuda").bfloat16()
        ours = host_us(lambda: mm.fused_matmul(a, w, norm="rmsnorm", gamma=gam,
                                               residual=res))
        print(f"host cost of a call, [{M}, 512] @ [512, 512] "
              f"{mm.gemm_plan(M, 512, 512).template}: fused_matmul "
              f"{ours:.1f} us, torch.matmul "
              f"{host_us(lambda: torch.matmul(a, w)):.1f} us", flush=True)
    if not ok:
        raise SystemExit("gemm_probe: a case is off its tolerance")
    print("gemm_probe: every case within tolerance")


if __name__ == "__main__":
    main()

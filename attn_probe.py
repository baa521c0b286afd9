"""Probe the attention kernels on one NVIDIA GPU, in a few minutes.

    python3 attn_probe.py

Builds `csrc/flash_attention.cu`, `csrc/paged_decode.cu` and
`csrc/decode_attention.cu` (printing ptxas' register and spill lines),
then runs `chip_smoke.py`'s three attention checks alone: `check_flash`
(every flash case against its plain version, the wgmma template gate,
device times beside SDPA's), `check_paged` (the paged kernel at 1, 2 and 4
splits and its normalized wrapper at `paged_splits`, one split included,
its merge kernel, each row by row against the plain version, with the
byte bound) and `check_decode_attention` (the dense kernel over gemma3's
and hymba's rings and a windowed linear cache, row by row against the
plain version at its split count and the TPU kernel's walk), and times the
dense kernel's device time at other split counts than `dense_splits`
picks.  A case off its
tolerance fails the run; so does a process that stalls for PROBE_STALL_S
seconds (a hung kernel holds the card until the call's own time limit).
`chip_smoke.py` is the whole check; this is the quick loop for attention
kernel work.
"""
from __future__ import annotations

import os
import subprocess
import threading

import torch

import chip_smoke

PROBE_STALL_S = 330


SWEEP_SPLITS = (8, 12, 16, 22, 32)


def dense_split_sweep():
    """Device time of the dense decode kernel (fold and merge) on each of
    chip_smoke.py's DECODE_CASES at the split count `dense_splits` picks
    and at SWEEP_SPLITS (`dense_splits` replaced for each timing)."""
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule_of = fd.dense_splits
    for label, H, KV, D, S, lens, win, dtype in chip_smoke.DECODE_CASES:
        B = len(lens)
        q = torch.randn((B, H, D), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, KV, D), generator=g, device="cuda"
                            ).to(dtype) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        rule = rule_of(B, KV, S, sms, window=win)
        times = []
        try:
            for n in sorted({rule, *SWEEP_SPLITS}):
                fd.dense_splits = lambda *a, n=n, **kw: n
                ms = chip_smoke.device_ms([
                    lambda: fd.decode_attention(q, k, v, ln, window=win)])
                times.append(f"{n}{' (rule)' if n == rule else ''}: "
                             + chip_smoke._ms(ms))
        finally:
            fd.dense_splits = rule_of
        chip_smoke.log(f"  dense split sweep, {label}: " + ", ".join(times))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("attn_probe: no CUDA device")
    stall = threading.Timer(PROBE_STALL_S, lambda: (
        print(f"attn_probe: stalled for {PROBE_STALL_S} s", flush=True),
        os._exit(3)))
    stall.daemon = True
    stall.start()
    from repro_torch.kernels import build
    chip_smoke.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    for r in build.build_all(("flash_attention", "paged_decode",
                              "decode_attention")):
        for line in r["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                chip_smoke.log(f"  ptxas[{r['name']}]: {line.strip()}")
    rows = {}
    chip_smoke.check_flash(rows)
    chip_smoke.check_paged(rows)
    chip_smoke.check_decode_attention(rows)
    dense_split_sweep()
    stall.cancel()
    chip_smoke.log("attn_probe: every case within tolerance")


if __name__ == "__main__":
    main()

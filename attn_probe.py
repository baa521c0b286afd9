"""Probe the attention kernels on one NVIDIA GPU, in a few minutes.

    python3 attn_probe.py

Builds `csrc/flash_attention.cu` and `csrc/paged_decode.cu` (printing
ptxas' register and spill lines), then runs `chip_smoke.py`'s two
attention checks alone: `check_flash` (every flash case against its plain
version, the wgmma template gate, device times beside SDPA's) and
`check_paged` (the paged kernel at 1, 2 and 4 splits and its normalized
wrapper at `paged_splits`, one split included, its merge kernel, each row
by row against the plain version, with the byte bound).  A case off its
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
    for r in build.build_all(("flash_attention", "paged_decode")):
        for line in r["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                chip_smoke.log(f"  ptxas[{r['name']}]: {line.strip()}")
    rows = {}
    chip_smoke.check_flash(rows)
    chip_smoke.check_paged(rows)
    stall.cancel()
    chip_smoke.log("attn_probe: every case within tolerance")


if __name__ == "__main__":
    main()

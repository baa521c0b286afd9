"""Probe the SSD and row-norm kernels on one NVIDIA GPU, in a few minutes.

    python3 ssm_probe.py [--prefill]

Builds `csrc/ssd.cu` and `csrc/rmsnorm.cu` (printing ptxas' register and
spill lines; with --prefill every source), then runs `chip_smoke.py`'s
checks of those kernels alone: `check_ssd` (hymba's and mamba2's shapes,
bf16 and fp32 operands, with each kernel's device time),
`check_residual_norms` (the residual add + norm at hymba's width beside
`F.rms_norm(x + y)` / `F.layer_norm(x + y)`, warm and cold in L2, and its
other dtype pairs and looped path) and `check_norms` (the plain norms and
their other paths); with --prefill also
`profile_prefill` of one 512-token pass of hymba-1.5b and of mamba2-2.7b at
full size (random seeded bf16 weights).  A case off its tolerance fails
the run; so does a process that stalls for PROBE_STALL_S seconds (a hung
kernel holds the card until the call's own time limit).  `chip_smoke.py` is
the whole check; this is the quick loop for SSD and norm kernel work.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading

import numpy as np
import torch

import chip_smoke

PROBE_STALL_S = 300


def prefill_profiles():
    """chip_smoke.profile_prefill for hymba-1.5b and mamba2-2.7b at full
    width and depth, one 512-token pass each."""
    from repro_torch.configs import HYMBA_1_5B, MAMBA2_2_7B
    from repro_torch.models import lm
    for seed, cfg in ((2, HYMBA_1_5B), (3, MAMBA2_2_7B)):
        params = lm.init_lm(cfg, dtype=torch.bfloat16, device="cuda",
                            seed=seed)
        chip_smoke.profile_prefill(cfg, params, np.random.default_rng(1))
        del params
        torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssm_probe: no CUDA device")
    stall = threading.Timer(PROBE_STALL_S, lambda: (
        print(f"ssm_probe: stalled for {PROBE_STALL_S} s", flush=True),
        os._exit(3)))
    stall.daemon = True
    stall.start()
    from repro_torch.kernels import build
    chip_smoke.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    prefill = "--prefill" in sys.argv[1:]
    names = build.SOURCES if prefill else ("ssd", "rmsnorm")
    for r in build.build_all(names):
        for line in r["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                chip_smoke.log(f"  ptxas[{r['name']}]: {line.strip()}")
    rows = {}
    chip_smoke.check_ssd(rows)
    chip_smoke.check_residual_norms(rows)
    chip_smoke.check_norms(rows)
    if prefill:
        prefill_profiles()
    stall.cancel()
    chip_smoke.log("ssm_probe: every case within tolerance")


if __name__ == "__main__":
    main()

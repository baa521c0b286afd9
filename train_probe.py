"""Probe training on one NVIDIA GPU, in a few minutes.

    python3 train_probe.py

Prints the card's name and power limit, the free disk and host memory
(`df`, `free`: the CLI writes GPT3-XL's 26.6 GB train state to disk once,
of the 45 GiB a call may write), builds `csrc/fused_matmul.cu`,
`csrc/flash_attention.cu` and `csrc/rmsnorm.cu` (the train path's three
kernels), then runs `chip_smoke.py`'s `train` phase alone (`phase_train`:
the autograd Functions' gates, the teacher gate, GPT3-XL whole with its
timed steps and profile, the train CLI with the restart-exact check
through its checkpoint and its resume, ViT-B's `vit_loss`) and prints the
kernels line's three gradient entries.  A gate
off its tolerance fails the run.  `chip_smoke.py` is the whole check; this
is the quick loop for training work.
"""
from __future__ import annotations

import json
import subprocess

import torch

import chip_smoke


def main():
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    chip_smoke.log(smi)
    chip_smoke.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for cmd in (["df", "-h", str(chip_smoke.ROOT)], ["free", "-g"]):
        chip_smoke.log(subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    for r in build.build_all(("fused_matmul", "flash_attention", "rmsnorm")):
        for line in r["log"].splitlines():
            if "registers" in line or "bytes stack" in line:
                chip_smoke.log(f"  ptxas[{r['name']}]: {line.strip()}")
    rows = {}
    out = chip_smoke.phase_train(rows, smi)
    for name in chip_smoke.GRAD_OF:
        src, replaces, case = chip_smoke.KERNELS[name]
        r = next(x for x in rows[name] if x["case"] == case)
        chip_smoke.log(json.dumps(dict(
            name=name, source=src, replaces=replaces,
            launches=chip_smoke._launches(name, None), **r)))
    path = chip_smoke.ROOT / "chiprun_out"
    path.mkdir(exist_ok=True)
    (path / "train_probe.json").write_text(json.dumps(
        {"rows": rows, "train": out}, indent=1, default=str))
    chip_smoke.log("train_probe: every gate held")


if __name__ == "__main__":
    main()

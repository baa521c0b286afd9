"""Tell the engine's host-clock serve numbers from the process's history, on
one NVIDIA GPU, in a few minutes.

    python3 serve_probe.py

Builds every source, serves mamba2-2.7b at full width and depth through
`chip_smoke.serve_model` (8 requests of 32 new tokens, random seeded bf16
weights) in a fresh process, runs `chip_smoke.py`'s kernels phase, then
serves it again, and prints the engine's decode step p50 / p95 and NAR
tok/s of both serves beside the card's name and power limit.  Run it in
two trees in one chip call (parent, change, change, parent) to ask whether
a difference in `chip_smoke.py`'s serve numbers follows the code or what
ran before the serve.  `chip_smoke.py` is the whole check.
"""
from __future__ import annotations

import json

import chip_smoke


def serve_once(label):
    from repro_torch.configs import MAMBA2_2_7B
    st = chip_smoke.serve_model(MAMBA2_2_7B, seed=3)["stats"]
    out = {k: st[k] for k in ("decode_step_p50_ms", "decode_step_p95_ms",
                              "nar_tok_s", "ar_tok_s")}
    chip_smoke.log(f"serve_probe {label}: {json.dumps(out)}")
    return out


def main():
    info = chip_smoke.phase_device()
    chip_smoke.phase_build()
    fresh = serve_once("fresh")
    rows = {}
    for check in (chip_smoke.check_gemm, chip_smoke.check_swiglu,
                  chip_smoke.check_norms, chip_smoke.check_residual_norms,
                  chip_smoke.check_ssd, chip_smoke.check_flash,
                  chip_smoke.check_paged, chip_smoke.check_decode_attention):
        check(rows)
    after = serve_once("after the kernels phase")
    chip_smoke.log(json.dumps({"card": info["nvidia_smi"], "fresh": fresh,
                               "after_kernels": after}))


if __name__ == "__main__":
    main()

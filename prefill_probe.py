"""Ask whether a captured decode step changes the host time of an eager
prefill pass in the same process, on one NVIDIA GPU, in about a minute.

    python3 prefill_probe.py

Builds the kernels, then times one 512-token hymba-1.5b prefill pass
through the fused stack and the head (`chip_smoke.teacher_forced`, random
seeded bf16 weights, host clock around a synchronised pass), 15 passes in
each state, in turns: no engine; an engine whose decode step is captured
(after a few replays); the engine deleted; a second engine; deleted again.
Prints the median and quartiles of each state beside the card's name and
power limit.  `chip_smoke.py` is the whole check.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import chip_smoke

PASSES = 15


def main():
    from repro_torch.configs import HYMBA_1_5B
    from repro_torch.core.precision import BF16
    from repro_torch.models import lm
    from repro_torch.serving import InferenceEngine, Request
    info = chip_smoke.phase_device()
    cfg = HYMBA_1_5B
    params = lm.init_lm(cfg, dtype=torch.bfloat16, device="cuda", seed=2)
    rng = np.random.default_rng(1)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 512),
                                       dtype=np.int32), device="cuda")

    def passes(label):
        ms = []
        for _ in range(PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chip_smoke.teacher_forced(cfg, params, prompt, mode="auto",
                                      fused=True, max_seq=512)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        q1, med, q3 = np.percentile(ms, (25, 50, 75))
        chip_smoke.log(f"prefill_probe {label:24s} median {med:7.2f} ms, "
                       f"quartiles {q1:7.2f} / {q3:7.2f} ({PASSES} passes; "
                       f"{info['nvidia_smi']})")
        return med

    def engine():
        eng = InferenceEngine(cfg, params, batch_size=4, max_seq=512,
                              block_size=16, policy=BF16)
        for uid in range(4):
            eng.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab, 200, dtype=np.int32), max_new_tokens=6))
        eng.run()
        if eng.runner.decode_step.fn.replays == 0:
            raise AssertionError("the engine's decode step never replayed")
        return eng

    passes("warm-up")
    out = {"no engine": passes("no engine")}
    eng = engine()
    out["captured engine"] = passes("captured engine")
    del eng
    torch.cuda.empty_cache()
    out["engine deleted"] = passes("engine deleted")
    eng = engine()
    out["second engine"] = passes("second engine")
    del eng
    torch.cuda.empty_cache()
    out["deleted again"] = passes("deleted again")
    chip_smoke.log(f"prefill_probe medians (ms): "
                   f"{ {k: round(float(v), 2) for k, v in out.items()} }")


if __name__ == "__main__":
    main()

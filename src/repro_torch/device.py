"""Device selection for the port's entry points.

Entry points (`lm.init_lm`, `InferenceEngine`, the kernel wrappers' callers)
run on the GPU unless the caller asks for the CPU: with no GPU and no
explicit `device="cpu"` they raise instead of quietly running on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the first CUDA card; `"cpu"` must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    return dev

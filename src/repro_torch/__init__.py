"""PyTorch / CUDA port of the `repro` serving stack, for NVIDIA Hopper.

Mirrors the reference package's layout (configs, core, kernels, models,
serving) and imports nothing from it.  Hand-written CUDA kernels live in
`kernels/csrc/` and build with nvcc at first use.
"""

"""Kernels: hand-written CUDA sources, their plain PyTorch versions and the dispatch layer."""

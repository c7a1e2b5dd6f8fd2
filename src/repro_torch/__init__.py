"""PyTorch / CUDA port of the `repro` package for one NVIDIA H100.

Mirrors `repro`'s module layout; every Pallas TPU kernel on the ported
path is a hand-written Hopper kernel under `csrc/`, wrapped in
`repro_torch.kernels`. The package imports torch, numpy and the standard
library only — never JAX and nothing of `repro`.
"""

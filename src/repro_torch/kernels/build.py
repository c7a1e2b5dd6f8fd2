"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` compiles with one `nvcc` call into its own shared
library with a plain C interface, loaded through `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries land in `build/repro_torch/`
at the repository root, named by a hash of the sources, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at import
time: a kernel is built the first time its wrapper launches it, or up front
through `build_all` (which starts every `nvcc` at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("dense_matmul", "bsr_matmul", "quant_matmul", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "gemm_tile.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Build every listed source that is not built yet, all `nvcc`s in
    parallel (each writes a temporary file, renamed into place once it
    succeeds); returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[str, Path, subprocess.Popen]] = []
    try:
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            with open(out.with_suffix(".log"), "w") as log:
                jobs.append((name, tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)))
        for name, tmp, proc in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   + ptxas_report(name))
            os.replace(tmp, _lib_path(name))
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The compiler's output for a source: errors, or the register and
    shared-memory lines of a successful build."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _LIBS:
        if not _lib_path(name).exists():
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def check_cuda_operands(name: str, dtype, *tensors) -> None:
    """The wrappers' launch preconditions: float operands f32 or bf16,
    every operand on one CUDA device and contiguous."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} is not float32 or bfloat16")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")

"""Counted work, device times and roofline terms of the port's figures (what
stands in for `repro.analysis.hlo` and `benchmarks/common.py::hlo_cost`).

The JAX package measures each figure point from XLA's compiled program: a
loop-aware FLOP count and a per-instruction byte count (every
instruction's operands and result). `hlo.py`'s counterpart, the dry-run's
op-by-op count of a whole step with its collectives and peak memory, is
`analysis.dispatch_cost`. Here, for the figures:

  * `count(fn, *args)` counts FLOPs with
    `torch.utils.flop_counter.FlopCounterMode` over one call of fn (MACs =
    FLOPs / 2). FlopCounterMode sees ATen operators only: a hand-written
    kernel launched through ctypes is not one, so a count over the kernel
    path reads 0. Counts therefore always come from a plain path (the
    training-time apply on `ops.reference_path()`, or the kernels' plain
    versions on CPU tensors), and times from the kernel path. Bytes are
    each input and output byte once (`nbytes`), the convention of the
    bounds in `chip_smoke.py` and PERF.md; XLA's per-instruction byte
    count has no counterpart.
  * `time_ms(fn, *args, iters)` is the median device time of one call from
    CUDA event pairs, L2 flushed before each call; it raises on a CPU
    tensor.
  * `roofline_seconds(flops, bytes, dtype)` and `bound_ms` work on the
    card's roof, `PEAKS[dtype]`: a `roofline.Peaks` at the NVIDIA H100
    80GB HBM3 data-sheet peaks of `launch.mesh`, the roof the figures,
    `chip_smoke.py`'s bounds and `roofline.roofline_point` share on the
    card.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable, Dict, Iterator, Tuple

import torch

from repro_torch.analysis.roofline import Peaks
from repro_torch.core import kratos as kr
from repro_torch.core import quantize as qz
from repro_torch.launch import mesh as M

# the card's roof for each operand type the port's kernels run in
PEAKS = {dtype: Peaks(peak_flops=peak, peak_bw=M.HBM_BW)
         for dtype, peak in M.PEAK_FLOPS.items()}

# after the L2 flush the stream is held busy by a ~1 ms sleep kernel queued
# before the start event, so the call's host work (a conv's im2col, the
# plain versions' dozens of small operators, argument checks, the launch
# plan, the launches) overlaps the sleep and the event pair times the
# device work alone (a ~0.1 ms sleep, enough for one kernel's launch, can
# be outrun by a conv point's host work, and the host's time is then read)
SLEEP_CYCLES = 2_000_000
FLUSH_BYTES = 64 << 20           # more than the H100's 50 MB L2


def tensors(*trees) -> Iterator[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples, PackedLinear and
    QuantizedTensor values."""
    for t in trees:
        if isinstance(t, torch.Tensor):
            yield t
        elif isinstance(t, dict):
            yield from tensors(*t.values())
        elif isinstance(t, (list, tuple)):
            yield from tensors(*t)
        elif isinstance(t, kr.PackedLinear):
            yield from tensors(t.buffers, t.indices)
        elif isinstance(t, qz.QuantizedTensor):
            yield from tensors(t.data, t.scale)


def nbytes(*trees) -> int:
    """Bytes of every tensor in `trees`, each once."""
    seen, total = set(), 0
    for t in tensors(*trees):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def count(fn: Callable, *args) -> Dict[str, float]:
    """{flops, macs, bytes} of one call fn(*args) on a plain path: FLOPs
    counted by FlopCounterMode, bytes each input and output byte once."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    flops = float(fc.get_total_flops())
    return {"flops": flops, "macs": flops / 2.0,
            "bytes": float(nbytes(args, out))}


_FLUSH: Dict[Any, torch.Tensor] = {}


def time_ms(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median device ms of fn(*args) over `iters` calls, CUDA events, L2
    flushed before each call. Every tensor argument must be on the card."""
    ts = list(tensors(args))
    bad = [t.device for t in ts if t.device.type != "cuda"]
    if not ts or bad:
        raise ValueError(f"time_ms times the card: got tensors on "
                         f"{bad or 'no device'}")
    dev = ts[0].device
    flush = _FLUSH.get(dev)
    if flush is None:
        flush = _FLUSH[dev] = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                          device=dev)
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize(dev)
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def roofline_seconds(flops: float, bytes_: float,
                     dtype: str = "float32") -> Dict[str, Any]:
    """Compute and memory terms of one call on the card's roof for
    `dtype`'s operations ('float32', 'bfloat16' or 'int8')."""
    peaks = PEAKS[dtype]
    t_c = flops / peaks.peak_flops
    t_m = bytes_ / peaks.peak_bw
    return {"t_compute": t_c, "t_memory": t_m, "t": max(t_c, t_m),
            "bound": "compute" if t_c >= t_m else "memory"}


def bound_ms(flops: float, bytes_: float,
             dtype: str = "float32") -> Tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it
    ('bytes' or 'operations')."""
    r = roofline_seconds(flops, bytes_, dtype)
    return r["t"] * 1e3, ("bytes" if r["t_memory"] >= r["t_compute"]
                          else "operations")

"""Ineffectual-work ledger probe: wrapper of `csrc/ledger_probe.cu`, and the
ledger row's column schema (serve.ledger re-exports it).

A port-only kernel: the JAX package's probe (`repro.serve.ledger.
LedgerProbe.measure`) is array code that XLA fuses into the jitted step, so
no Pallas kernel stands behind it. `ledger_probe` adds one row for an
activation into a ledger row in place: a CUDA tensor launches the kernel
on the current stream (one launch a tap), a CPU tensor adds the plain
version, `ledger_row_ref`. The kernel counts in integers and forms the f32
columns once, so its row is the same bits in every run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

# Fixed columns of a probe row; histogram bins follow (group + 1 of them).
C_ELEMS = 0          # activation elements probed
C_ZEROS = 1          # exact zeros
C_NEAR = 2           # |x| <= threshold
C_GROUPS = 3         # channel groups probed
C_KBLOCKS = 4        # k-blocks examined (per activation row)
C_DEAD_KB = 5        # k-blocks entirely near-zero (skippable work)
C_FLOPS_DENSE = 6    # dense MACs*2 the probed GEMMs would do
C_FLOPS_EFF = 7      # ... minus the dead-k-block share
C_BYTES_DENSE = 8    # act read + weight read + out write, dense
C_BYTES_EFF = 9      # weight-read term scaled by the live-k-block share
N_FIXED = 10
C_HIST = N_FIXED     # first histogram bin (bin j = j near-zero channels)

THREADS = 256
MAX_CTAS = 264               # two a streaming multiprocessor of an H100
ELEMS_PER_THREAD = 8

_c = ctypes.c_void_p
_i = ctypes.c_int
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}


@functools.cache
def _lib():
    fn = build.load("ledger_probe").ledger_probe_launch
    fn.argtypes = [_c, _i, ctypes.c_longlong, _i, _i, ctypes.c_float, _i, _i,
                   _c, _c, _i, _c]
    fn.restype = _i
    return fn


def probe_ctas(n_elems: int) -> int:
    """CTAs of a launch: ~8 elements a thread, at most two an SM."""
    return max(1, min(MAX_CTAS, -(-n_elems // (THREADS * ELEMS_PER_THREAD))))


def _scratch(device: torch.device, group: int) -> torch.Tensor:
    """The kernel's integer counters and CTA ticket, zero between launches
    (the last CTA resets them): one per device and group width, made on
    the first launch, so a CUDA graph's capture allocates nothing."""
    key = (device, group)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(5 + group, dtype=torch.int32,
                                    device=device)
    return _SCRATCH[key]


def _row(x: torch.Tensor, n_out: int, counts, dg: int,
         dk: int) -> torch.Tensor:
    """The f32 row from the integer counts (n_zero, n_near, hist, dead),
    with the reference's f32 arithmetic."""
    n_zero, n_near, hist, dead = counts
    f32, dev = torch.float32, x.device
    d = x.shape[-1]
    rows = x.numel() // d

    def c(v):
        return torch.full((), v, dtype=f32, device=dev)
    n_kb = float(rows * dk)
    dead_f = dead.to(f32)
    live = 1.0 - dead_f / c(max(n_kb, 1.0)) if dk else c(1.0)
    flops = float(2 * rows * d * n_out)
    act_bytes = float(4 * (rows * d + rows * n_out))
    w_bytes = float(4 * d * n_out)
    fixed = torch.stack([
        c(rows * d), n_zero.to(f32), n_near.to(f32), c(rows * dg), c(n_kb),
        dead_f, c(flops), c(flops) * live, c(act_bytes + w_bytes),
        c(act_bytes) + c(w_bytes) * live])
    return torch.cat([fixed, hist.to(f32)])


def ledger_row_ref(x: torch.Tensor, n_out: int, *, threshold: float,
                   group: int, k_block: int) -> torch.Tensor:
    """The plain version: one (N_FIXED + group + 1,) f32 row for activation
    `x` (..., d) feeding a GEMM of fan-out `n_out`, as the JAX package's
    `LedgerProbe.measure` computes it."""
    x = x.float()
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    rows = flat.shape[0]
    near = flat.abs() <= threshold
    n_zero = (flat == 0.0).sum()
    n_near = near.sum()
    dg, dk = d // group, d // k_block
    if dg:
        cnt = near[:, :dg * group].reshape(rows, dg, group).sum(-1)
        hist = torch.bincount(cnt.reshape(-1), minlength=group + 1)
    else:
        hist = torch.zeros(group + 1, dtype=torch.int64, device=x.device)
    if dk:
        dead = near[:, :dk * k_block].reshape(rows, dk, k_block) \
            .all(-1).sum()
    else:
        dead = torch.zeros((), dtype=torch.int64, device=x.device)
    return _row(flat, n_out, (n_zero, n_near, hist, dead), dg, dk)


def ledger_probe(x: torch.Tensor, n_out: int, out_row: torch.Tensor, *,
                 threshold: float, group: int, k_block: int) -> torch.Tensor:
    """Add the ledger row of activation `x` (..., d), feeding a GEMM of
    fan-out `n_out`, into `out_row` ((N_FIXED + group + 1,) f32, in
    place); returns `out_row`."""
    build.check_autograd("ledger_probe", x, out_row)
    width = N_FIXED + group + 1
    if tuple(out_row.shape) != (width,) or out_row.dtype != torch.float32:
        raise ValueError(f"ledger_probe: out_row {tuple(out_row.shape)} "
                         f"{out_row.dtype}, expected ({width},) float32")
    if group < 1 or k_block < 1 or n_out < 1 or x.dim() < 1:
        raise ValueError(f"ledger_probe: group {group}, k_block {k_block}, "
                         f"n_out {n_out}, x {tuple(x.shape)}")
    if x.device.type == "cpu":
        out_row += ledger_row_ref(x, n_out, threshold=threshold, group=group,
                                  k_block=k_block)
        return out_row
    if x.device.type != "cuda":
        raise ValueError(f"ledger_probe: unsupported device {x.device}")
    x = x.contiguous()
    build.check_cuda_operands("ledger_probe", x.dtype, x, out_row)
    d = x.shape[-1]
    rows = x.numel() // d
    rc = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), rows, d, n_out,
                float(threshold), group, k_block, out_row.data_ptr(),
                _scratch(x.device, group).data_ptr(),
                probe_ctas(rows * d),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "ledger_probe")
    ledger_probe.launches += 1
    return out_row


ledger_probe.launches = 0

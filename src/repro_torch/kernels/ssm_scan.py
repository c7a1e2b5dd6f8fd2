"""Mamba-1 selective scan: wrapper of `csrc/ssm_scan.cu`.

Replaces `repro.kernels.ssm_scan.ssm_scan`. A CUDA tensor launches the
hand-written kernel on the current stream; a CPU tensor takes the plain
version (`ref.ssm_scan_ref`). Any S >= 1 and any d_inner (the kernel masks
the ragged edges instead of the Pallas kernel's divisibility rules);
d_state <= 32.

`scan_plan` fixes the launch from the shapes alone: the groups of 4 state
elements a channel's state splits into (one warp each), the CTA shape and
its shared memory. Every CTA scans the whole sequence for its channels. The
C launcher checks the plan against its own instantiations, so the choice
runs and is tested on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssm_scan_ref

MAX_D_STATE = 32
SCAN_STATES = 4          # state elements a lane holds (one group)

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("ssm_scan").ssm_scan_launch
    fn.argtypes = [_c, _c, _c, _c, _c, _c, _c] + [_i] * 7 + [_c]
    fn.restype = _i
    return fn


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    groups: int       # state groups of a channel, one warp each
    channels: int     # channels of a CTA
    smem_bytes: int   # the kernel's dynamic shared memory
    threads: int


def scan_groups(st: int) -> int:
    """The fewest power-of-two groups of 4 states that hold d_state."""
    return next(g for g in (1, 2, 4, 8) if SCAN_STATES * g >= st)


def scan_threads(groups: int) -> int:
    """A CTA: 4 warps, or one per group where a channel has 8."""
    return 32 * max(4, groups)


def scan_smem_bytes(groups: int) -> int:
    """u and dt (staged positions x channels), b and c (staged positions x
    4 groups) and each group's part of y (staged positions x groups x
    channels), f32."""
    threads = scan_threads(groups)
    channels = threads // groups
    staged = 16 if groups == 1 else 32
    return 4 * (2 * staged * channels + 2 * staged * SCAN_STATES * groups
                + staged * groups * channels)


@functools.lru_cache(maxsize=None)
def scan_plan(bsz: int, s: int, di: int, st: int) -> ScanPlan:
    """The fewest groups of 4 states that hold d_state, and a CTA of
    channels for each (channel block, batch row)."""
    if min(bsz, s, di) < 1 or bsz > 65535:
        raise ValueError(f"scan plan: batch {bsz}, length {s}, d_inner {di}")
    if not 1 <= st <= MAX_D_STATE:
        raise ValueError(f"scan plan: d_state {st} not in [1, {MAX_D_STATE}]")
    groups = scan_groups(st)
    threads = scan_threads(groups)
    channels = threads // groups
    blocks = -(-di // channels)
    if blocks > 65535:
        raise ValueError(f"scan plan: d_inner {di} needs {blocks} CTAs a row")
    return ScanPlan(groups, channels, scan_smem_bytes(groups), threads)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor):
    """u, dt: (B, S, di); b, c: (B, S, st), one float dtype; a: (di, st)
    f32. Returns (y (B, S, di) in u's dtype, h_final (B, di, st) f32)."""
    build.check_autograd("ssm_scan", u, dt, b, c, a)
    bsz, s, di = u.shape
    st = a.shape[1]
    if (tuple(dt.shape) != tuple(u.shape) or tuple(a.shape) != (di, st)
            or tuple(b.shape) != (bsz, s, st) or b.shape != c.shape
            or s < 1):
        raise ValueError(f"ssm_scan: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}")
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, b, c, a)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan: unsupported device {u.device}")
    if not 1 <= st <= MAX_D_STATE:
        raise ValueError(f"ssm_scan: d_state {st} not in [1, {MAX_D_STATE}]")
    if {dt.dtype, b.dtype, c.dtype} != {u.dtype} or a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: u/dt/b/c {u.dtype}/{dt.dtype}/{b.dtype}/"
                        f"{c.dtype} must share one dtype and a {a.dtype} "
                        "must be float32")
    build.check_cuda_operands("ssm_scan", u.dtype, u, dt, b, c, a)
    pl = scan_plan(bsz, s, di, st)
    y = torch.empty_like(u)
    h = torch.empty((bsz, di, st), dtype=torch.float32, device=u.device)
    rc = _lib()(u.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                a.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, di, st,
                int(u.dtype == torch.bfloat16), pl.groups, pl.smem_bytes,
                torch.cuda.current_stream(u.device).cuda_stream)
    build.check(rc, "ssm_scan")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0

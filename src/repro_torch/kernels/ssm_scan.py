"""Mamba-1 selective scan: wrapper of `csrc/ssm_scan.cu`.

Replaces `repro.kernels.ssm_scan.ssm_scan`. A CUDA tensor launches the
hand-written kernel on the current stream; a CPU tensor takes the plain
version (`ref.ssm_scan_ref`). Any S >= 1 and any d_inner (the kernel masks
the ragged edges instead of the Pallas kernel's divisibility rules);
d_state <= 32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssm_scan_ref

MAX_D_STATE = 32

_c = ctypes.c_void_p
_i = ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("ssm_scan").ssm_scan_launch
    fn.argtypes = [_c, _c, _c, _c, _c, _c, _c, _i, _i, _i, _i, _i, _c]
    fn.restype = _i
    return fn


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor):
    """u, dt: (B, S, di); b, c: (B, S, st), one float dtype; a: (di, st)
    f32. Returns (y (B, S, di) in u's dtype, h_final (B, di, st) f32)."""
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
    y = torch.empty_like(u)
    h = torch.empty((bsz, di, st), dtype=torch.float32, device=u.device)
    rc = _lib()(u.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                a.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, s, di, st,
                int(u.dtype == torch.bfloat16),
                torch.cuda.current_stream(u.device).cuda_stream)
    build.check(rc, "ssm_scan")
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0

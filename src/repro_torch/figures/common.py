"""Shared machinery of the port's figures (counterpart of
`benchmarks/common.py`).

The JAX package measures each point from its compiled HLO. Here a point's
counts (MACs, bytes) come from its plain path (`analysis.cost.count`) and
its time from the packed artifact on the hand-written kernels
(`analysis.cost.time_ms`), at the NVIDIA H100 data-sheet peaks of
`launch.mesh`. Every timed point is first held against the plain version
of the same packed buffers, and must have launched exactly the wrapper
its buffers select: a kernel that fails raises, nothing falls back. On
the CPU (`--device cpu`) the analytic and counted columns are printed and
every measured time is `-`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict

import torch

from repro_torch.analysis import cost
from repro_torch.core import kratos as kr
from repro_torch.core import quantize as qz
from repro_torch.kernels import gemm_plan, ops

DASH = "-"                       # a time the run did not measure
SEED = 0
# the kernels' tolerances against their plain versions (tests/test_kernels.py)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2.0 ** -7)}
DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class CSV:
    """Print aligned CSV to stdout and collect rows."""

    def __init__(self, header):
        self.header = header
        self.rows = []
        print(",".join(header))

    def row(self, *vals):
        r = [f"{v:.6g}" if isinstance(v, float) else str(v) for v in vals]
        self.rows.append(r)
        print(",".join(r))
        sys.stdout.flush()

    def records(self):
        return [dict(zip(self.header, r)) for r in self.rows]


def require_device(device) -> torch.device:
    """The figures time the card; without one, only device='cpu' runs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the figures time the "
                           "hand-written kernels on the card; pass --device "
                           "cpu for the analytic and counted columns")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(SEED)


def packed_format(lin: kr.PackedLinear) -> str:
    """The buffer format `pack` produced: 'w', 'qt-w4', 'qt-w8a8',
    'blocks', 'qblocks-w8' (a tree point whose 1-wide k extent does not
    divide the values per byte keeps float blocks)."""
    kernel = kr.packed_kernel(lin)
    if kernel == "quant_matmul":
        return f"qt-w{lin.buffers['qt'].bits}"
    return {"dense_matmul": "w", "quant_matmul_w8a8": "qt-w8a8",
            "bsr_matmul": "blocks",
            "bsr_quant_matmul": f"qblocks-w{lin.spec.bits}"}[kernel]


def kernel_of(lin: kr.PackedLinear, m: int, elem: int) -> str:
    """'wrapper/form': the kernel wrapper `apply_packed` calls for `lin` at
    m rows of `elem`-byte activations, and its launch plan's form."""
    kernel, b, n, p = kr.packed_kernel(lin), lin.buffers, lin.n_in, lin.n_out
    if kernel == "dense_matmul":
        form = gemm_plan.plan(m, n, p, elem=elem).form
    elif kernel == "quant_matmul_w8a8":
        form = gemm_plan.w8a8_plan(m, n, p).form
    elif kernel == "quant_matmul":
        form = gemm_plan.plan(m, n, p, bits=b["qt"].bits, elem=elem).form
    elif kernel == "bsr_matmul":
        n_pb, nnz, bk, bn = b["blocks"].shape
        form = gemm_plan.bsr_plan(m, n_pb, nnz, bk, bn, 0, elem).form
    else:
        n_pb, nnz, bkp, bn = b["qblocks"].shape
        bits = lin.spec.bits
        form = gemm_plan.bsr_plan(m, n_pb, nnz, bkp * qz.VALUES_PER_BYTE[bits],
                                  bn, bits, elem).form
    return f"{kernel}/{form}"


def on_card(fn: Callable, args, plain: Callable, *, wrapper: str,
            dtype: torch.dtype, flops: float, iters: int = 10,
            plain_ms: bool = False) -> Dict[str, object]:
    """One point of a figure: fn(*args) on the kernels, held against
    plain(*args) at TOL[dtype]; exactly one launch of `wrapper` (and of no
    other kernel) per call. Returns device_ms, bound_ms (each input and
    output byte once, `flops` at dtype's peak), bound_by, max_abs_err and,
    with `plain_ms`, the plain version's device ms. On CPU tensors only
    the bound is computed and the rest is DASH."""
    before = ops.launch_counts()
    y = fn(*args)
    after = ops.launch_counts()
    bound, by = cost.bound_ms(flops, cost.nbytes(args, y), DTYPE_NAME[dtype])
    out = {"device_ms": DASH, "bound_ms": bound, "bound_by": by,
           "max_abs_err": DASH, "plain_ms": DASH}
    if y.device.type != "cuda":
        return out
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    if ran != {wrapper: 1}:
        raise AssertionError(f"expected one launch of {wrapper}, got {ran}")
    want = plain(*args)
    err = (y.float() - want.float()).abs()
    atol, rtol = TOL[dtype]
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{wrapper}: max |kernel - plain| "
                             f"{err.max().item():.3g} over tolerance "
                             f"(atol {atol}, rtol {rtol})")
    out["max_abs_err"] = err.max().item()
    out["device_ms"] = cost.time_ms(fn, *args, iters=iters)
    if plain_ms:
        out["plain_ms"] = cost.time_ms(plain, *args, iters=iters)
    return out


def fmt_ms(v) -> object:
    """A time for a CSV cell: the float, or DASH where not measured."""
    return v if isinstance(v, float) else DASH


def point(spec, device, *, plain_ms: bool = False) -> Dict[str, object]:
    """A Table II point (`core.bench_specs.KernelSpec`) end to end: its
    counted MACs and bytes on the plain path (the training-time apply),
    its packed form's kernel, format and bound, and on the card its
    device ms against the plain version of the same packed buffers.
    Also returns the point's `params`, `x`, `packed` and packed `fn`."""
    from repro_torch.core import bench_specs as BS
    params, x, fn = BS.instantiate(spec, generator=generator(device),
                                   device=device)
    counted = cost.count(fn, params, x)
    packed, pfn = BS.pack_point(spec, params)
    lin = packed["w"]
    operand = BS.patches(spec, x).reshape(-1, lin.n_in)

    def plain(p, xx):
        return kr.plain_packed(p["w"], BS.patches(spec, xx))
    kernel = kernel_of(lin, operand.shape[0], operand.element_size())
    # the bound's operations: what the plain version of this packed point
    # does (a systolic point multiplies its masked dense weight)
    flops = cost.count(kr.plain_packed, lin, operand)["flops"]
    res = on_card(pfn, (packed, x), plain, wrapper=kernel.split("/")[0],
                  dtype=x.dtype, flops=flops, plain_ms=plain_ms)
    res.update(macs=counted["macs"], bytes=counted["bytes"], kernel=kernel,
               format=packed_format(lin), params=params, packed=packed, x=x,
               fn=pfn)
    return res

"""The Kratos benchmark design space (paper Tables I & II) as config objects
(port of `repro.core.bench_specs`).

Eight kernels ({gemmt, gemms} x {row-parallel, fully-unrolled} and
{conv1d, conv2d} x {pixelwise, row-parallel, fully-unrolled}), each in a
Small and Large variant, swept over 10 sparsity levels (0 .. 0.9) and 4
precisions (8/4/2/1-bit): the paper's §IV-B evaluation grid, the same 800
points as the JAX package's.

`instantiate()` builds (params, x, fn), `fn` the training-time apply on
the reference path (the JAX package's `backend="ref"`). `pack_point()`
freezes the same weights through `pack_linear` and returns the serving
form, whose `fn` runs `apply_packed`: the hand-written kernels on the
card, the point the figures time. The analytic resource model
(`resource_report`, `ops_per_invocation`) is shared with the JAX package
number for number.

The grid is element-granular (bk = bn = 1), the paper's FPGA granularity.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import conv as kconv
from repro_torch.core import kratos as kr
from repro_torch.kernels import ops

SPARSITIES = tuple(round(0.1 * i, 1) for i in range(10))   # 0.0 .. 0.9
PRECISIONS = (8, 4, 2, 1)
GEMMS = ("gemmt", "gemms")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str                    # e.g. 'gemmt-RP-S'
    kernel: str                  # gemmt | gemms | conv1d | conv2d
    unroll: str                  # pixelwise | row | full
    size: str                    # S | L
    # GEMM: (m, n, p). Conv: input (Iw[,Ih],Ic), filter (Fw[,Fh]), Oc.
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    sparsity: float = 0.0
    bits: Optional[int] = None
    bk: int = 1                  # element-granular by default (FPGA parity)
    bn: int = 1

    def kratos_spec(self) -> kr.KratosSpec:
        impl = "systolic" if self.kernel == "gemms" else "tree"
        return kr.KratosSpec(sparsity=self.sparsity, bits=self.bits,
                             impl=impl, unroll=self.unroll, bk=self.bk,
                             bn=self.bn, seed=17)

    # --- analytic resource model -------------------------------------------
    def gemm_dims(self) -> Tuple[int, int, int]:
        d = self.dims
        if self.kernel in GEMMS:
            return d["m"], d["n"], d["p"]
        if self.kernel == "conv1d":
            ow = d["iw"] - d["fw"] + 1
            return ow, d["fw"] * d["ic"], d["oc"]
        ow, oh = d["iw"] - d["fw"] + 1, d["ih"] - d["fh"] + 1
        return ow * oh, d["fw"] * d["fh"] * d["ic"], d["oc"]

    def ops_per_invocation(self) -> int:
        """MACs per 'cycle' under the spec's unroll factor (Table I column)."""
        m, n, p = self.gemm_dims()
        if self.unroll == "full":
            return m * n * p
        if self.unroll == "row":
            if self.kernel == "conv2d":
                ow = self.dims["iw"] - self.dims["fw"] + 1
                return ow * n * p
            return n * p                     # one GEMM row / one conv row
        return n * p                         # pixelwise: one output pixel

    def resource_report(self) -> Dict[str, float]:
        m, n, p = self.gemm_dims()
        return kr.cost_report(n, p, self.kratos_spec(), m=m)


def _mk(name, kernel, unroll, size, **dims) -> KernelSpec:
    return KernelSpec(name=name, kernel=kernel, unroll=unroll, size=size,
                      dims=dims)


# Paper Table II, verbatim sizes (conv shapes read per the Table-II format
# row: input Iw x Ih x Ic, filter Fw x Fh, output channels Oc; conv1d uses
# Ih = Fh = 1).
TABLE_II: Tuple[KernelSpec, ...] = (
    _mk("gemmt-RP-S", "gemmt", "row", "S", m=32, n=32, p=32),
    _mk("gemmt-RP-L", "gemmt", "row", "L", m=128, n=128, p=128),
    _mk("gemmt-FU-S", "gemmt", "full", "S", m=16, n=16, p=16),
    _mk("gemmt-FU-L", "gemmt", "full", "L", m=32, n=32, p=32),
    _mk("gemms-RP-S", "gemms", "row", "S", m=16, n=16, p=16),
    _mk("gemms-RP-L", "gemms", "row", "L", m=128, n=128, p=128),
    _mk("conv1d-PW-S", "conv1d", "pixelwise", "S", iw=32, ic=64, fw=3, oc=64),
    _mk("conv1d-PW-L", "conv1d", "pixelwise", "L", iw=32, ic=64, fw=3, oc=128),
    _mk("conv1d-FU-S", "conv1d", "full", "S", iw=32, ic=8, fw=3, oc=8),
    _mk("conv1d-FU-L", "conv1d", "full", "L", iw=32, ic=16, fw=3, oc=16),
    _mk("conv2d-PW-S", "conv2d", "pixelwise", "S", iw=25, ih=25, ic=32, fw=3, fh=3, oc=64),
    _mk("conv2d-PW-L", "conv2d", "pixelwise", "L", iw=25, ih=25, ic=64, fw=3, fh=3, oc=64),
    _mk("conv2d-RP-S", "conv2d", "row", "S", iw=8, ih=8, ic=8, fw=3, fh=3, oc=8),
    _mk("conv2d-RP-L", "conv2d", "row", "L", iw=8, ih=8, ic=16, fw=3, fh=3, oc=16),
    _mk("conv2d-FU-S", "conv2d", "full", "S", iw=8, ih=8, ic=4, fw=3, fh=3, oc=4),
    _mk("conv2d-FU-L", "conv2d", "full", "L", iw=8, ih=8, ic=8, fw=3, fh=3, oc=8),
)

BY_NAME = {s.name: s for s in TABLE_II}


def sweep(base: KernelSpec, sparsities=SPARSITIES,
          precisions=(None,) + PRECISIONS) -> List[KernelSpec]:
    """The paper's batch-job grid for one kernel."""
    return [dataclasses.replace(base, sparsity=s, bits=b)
            for s, b in itertools.product(sparsities, precisions)]


def patches(spec: KernelSpec, x: torch.Tensor) -> torch.Tensor:
    """The GEMM operand of a point's input: x itself for a GEMM, its
    im2col patches for a convolution (rows = the leading axes)."""
    d = spec.dims
    if spec.kernel in GEMMS:
        return x
    if spec.kernel == "conv1d":
        return kconv.im2col_1d(x, d["fw"])
    return kconv.im2col_2d(x, d["fw"], d["fh"])


def _forward(spec: KernelSpec, p: Dict, x: torch.Tensor) -> torch.Tensor:
    ks, d = spec.kratos_spec(), spec.dims
    if spec.kernel in GEMMS:
        return kr.apply(p["w"] if isinstance(p["w"], kr.PackedLinear)
                        else p, x, ks)
    if spec.kernel == "conv1d":
        return kconv.conv1d(dict(p, fw=d["fw"]), x, ks)
    return kconv.conv2d(dict(p, fw=d["fw"], fh=d["fh"]), x, ks)


def instantiate(spec: KernelSpec, *, generator: torch.Generator, device,
                batch: int = 1):
    """Build (params, x, fn) for a spec; fn(params, x) -> y is the
    training-time apply on the reference path. params holds the dense
    `{"w"}` weight only (the filter sizes are the spec's, as the JAX
    package's fn closes over them); the weight is drawn first, then x."""
    ks, d = spec.kratos_spec(), spec.dims
    kw = dict(generator=generator, device=device)
    if spec.kernel in GEMMS:
        params = kr.init(d["n"], d["p"], ks, **kw)
        shape = (batch * d["m"], d["n"])
    elif spec.kernel == "conv1d":
        params = kconv.conv1d_init(d["fw"], d["ic"], d["oc"], ks, **kw)
        shape = (batch, d["iw"], d["ic"])
    else:
        params = kconv.conv2d_init(d["fw"], d["fh"], d["ic"], d["oc"], ks,
                                   **kw)
        shape = (batch, d["iw"], d["ih"], d["ic"])
    params = {"w": params["w"]}
    x = torch.randn(shape, **kw)

    def fn(p, xx):
        with ops.reference_path():
            return _forward(spec, p, xx)
    return params, x, fn


def pack_point(spec: KernelSpec, params: Dict
               ) -> Tuple[Dict, Callable[[Dict, torch.Tensor], torch.Tensor]]:
    """The serving form of an instantiated point: (packed, fn), packed
    `{"w": PackedLinear}` from `pack_linear` under the point's spec (a
    k extent that does not divide the values per byte keeps float blocks,
    `kratos.serving_spec`), fn(packed, x) -> y through `apply_packed`."""
    packed = {"w": kr.pack_linear({"w": params["w"]}, spec.kratos_spec())}

    def fn(p, xx):
        return _forward(spec, p, xx)
    return packed, fn

"""Fig. 6 reproduction: resource utilization vs precision (port of
`benchmarks/fig6_precision.py`).

Paper claim (C2): FPGA area falls super-linearly with bit-width
(multipliers are quadratic in bits), e.g. conv2d-FU-L drops 2.9x from
8-bit to 4-bit, comparable to 80-90% sparsity.

On fixed silicon the quadratic area win degrades to a linear weight-byte
win (packed int codes) plus a 2x tensor-core rate credit for w8a8. The
byte columns (`weight_bytes`, `bytes_fraction`, `equiv_sparsity`) are the
JAX package's; `time_fraction` is the roofline time of one application
against the dense bf16 one at the H100's data-sheet peaks; `device_ms`
times the packed point on the hand-written kernels (f32 activations).

  PYTHONPATH=src python -m repro_torch.figures.fig6_precision [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.analysis.cost import roofline_seconds
from repro_torch.core import bench_specs as BS
from repro_torch.core import kratos as kr
from repro_torch.core import quantize as qz
from repro_torch.figures.common import CSV, fmt_ms, point, require_device

DEFAULT = ("gemmt-RP-L", "conv2d-FU-L", "conv1d-PW-L")
BITS = (None, 8, 4, 2, 1)


def run(kernels=DEFAULT, sparsities=(0.0, 0.5, 0.9), *,
        device="cuda") -> dict:
    device = require_device(device)
    csv = CSV(["kernel", "sparsity", "bits", "weight_bytes",
               "bytes_fraction", "time_fraction", "equiv_sparsity",
               "device_ms", "bound_ms", "kernel_form", "format"])
    for name in kernels:
        base = BS.BY_NAME[name]
        m, n, p = base.gemm_dims()
        dense_bytes = 2.0 * n * p           # bf16 reference
        for s in sparsities:
            for bits in BITS:
                spec = dataclasses.replace(base, sparsity=s, bits=bits)
                ks = spec.kratos_spec()
                rep = kr.cost_report(n, p, ks, m=m)
                wb = rep["weight_bytes"]
                # roofline time of one application at this precision
                t = roofline_seconds(2 * rep["effective_macs"],
                                     wb + 2.0 * m * (n + p),
                                     "int8" if ks.act_bits == 8
                                     else "bfloat16")
                t_dense = roofline_seconds(2 * m * n * p,
                                           dense_bytes + 2.0 * m * (n + p),
                                           "bfloat16")
                tf = t["t"] / t_dense["t"]
                # sparsity that would buy the same byte reduction at bf16
                equiv_s = 1.0 - min(1.0, wb / dense_bytes)
                pt = point(spec, device)
                csv.row(name, s, bits or 16, wb, wb / dense_bytes, tf,
                        equiv_s, fmt_ms(pt["device_ms"]), pt["bound_ms"],
                        pt["kernel"], pt["format"])
    print("\n# C2 check: paper sees 2.9x AREA 8->4bit (quadratic); on the")
    print("# card the same step buys exactly 2x weight BYTES (linear), and a")
    print("# 1-wide tree point below 8 bits keeps float blocks (format")
    print("# column). 8-bit + act8 additionally gets the 2x int8 tensor-core")
    print("# rate credit (time_fraction 0.5 when compute-bound).")
    return {"csv": csv.records()}


def verify_packed_sizes() -> None:
    """Cross-check the analytic byte counts against real packed buffers."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((256, 128), generator=gen)
    for bits in (8, 4, 2, 1):
        qt = qz.quantize(w, bits)
        expect = 256 * 128 * bits / 8
        assert qt.data.numel() == expect, (bits, qt.data.numel(), expect)
    print("# packed-size cross-check ok (8/4/2/1-bit)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    verify_packed_sizes()
    run(device=a.device)


if __name__ == "__main__":
    main()

"""Fig. 1 reproduction: the compounding story on a 64x64 GEMM (port of
`benchmarks/fig1_unrolled_area.py`).

Paper claim (C5): naive unrolling of a 64x64x64 matmul eats 63% of an
Arria-10; specialization cuts ~4x, and specialization + pruning +
quantization compounds to ~600x (0.1% of the device).

Restated on the card: 'area' is effective resource-seconds. The four
configurations of the JAX package (bf16 activations past the first; 4 x 4
blocks):
    naive_f32           dense GEMM, f32 weights and activations
    specialized_bf16    dense, bf16
    spec+prune0.9       tree kernel at 90% balanced sparsity
    spec+prune0.9+4bit  tree kernel, 90% sparse, 4-bit packed weights
`hlo_macs` is counted on the packed point's plain path, `weight_bytes` and
`t_roofline_ns` are the JAX package's analytic bytes and the roofline at
the H100's data-sheet peak of each configuration's activation type;
`device_ms` times the packed point on the hand-written kernels.

  PYTHONPATH=src python -m repro_torch.figures.fig1_unrolled_area [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.analysis import cost
from repro_torch.core import kratos as kr
from repro_torch.figures.common import (CSV, DTYPE_NAME, fmt_ms, generator,
                                        kernel_of, on_card, packed_format,
                                        require_device)

N = 64
CONFIGS = (
    ("naive_f32", kr.KratosSpec(), torch.float32, 4),
    ("specialized_bf16", kr.KratosSpec(), torch.bfloat16, 2),
    ("spec+prune0.9", kr.KratosSpec(sparsity=0.9, bk=4, bn=4),
     torch.bfloat16, 2),
    ("spec+prune0.9+4bit", kr.KratosSpec(sparsity=0.9, bits=4, bk=4, bn=4),
     torch.bfloat16, 0.5),
)


def packed_in(lin: kr.PackedLinear, dtype) -> kr.PackedLinear:
    """`lin` with its float buffers ('w', 'blocks') in the activations'
    dtype, so a timed call casts nothing."""
    buffers = {k: (v.to(dtype) if k in ("w", "blocks") else v)
               for k, v in lin.buffers.items()}
    return kr.PackedLinear(buffers=buffers, n_in=lin.n_in, n_out=lin.n_out,
                           spec=lin.spec, indices=lin.indices)


def run(*, device="cuda") -> dict:
    device = require_device(device)
    gen = generator(device)
    x = torch.randn((N, N), generator=gen, device=device)
    csv = CSV(["config", "hlo_macs", "weight_bytes", "t_roofline_ns",
               "mac_reduction", "byte_reduction", "time_reduction",
               "device_ms", "bound_ms", "kernel_form", "format"])
    base = None
    for name, spec, dtype, bytes_per_w in CONFIGS:
        params = kr.init(N, N, spec, generator=generator(device),
                         device=device)
        lin = packed_in(kr.pack_linear(params, spec), dtype)
        xx = x.to(dtype)
        counted = cost.count(kr.plain_packed, lin, xx)
        rep = kr.cost_report(N, N, spec, m=N)
        wb = rep["weight_bytes_fraction"] * 2 * N * N * (bytes_per_w / 2) \
            if name == "naive_f32" else rep["weight_bytes"]
        t = cost.roofline_seconds(counted["flops"], wb + 2 * 2 * N * N,
                                  DTYPE_NAME[dtype])["t"]
        if base is None:
            base = (counted["macs"], wb, t)
        kernel = kernel_of(lin, N, xx.element_size())
        pt = on_card(kr.apply_packed, (lin, xx), kr.plain_packed,
                     wrapper=kernel.split("/")[0], dtype=dtype,
                     flops=counted["flops"])
        csv.row(name, counted["macs"], wb, t * 1e9,
                base[0] / max(counted["macs"], 1), base[1] / max(wb, 1e-9),
                base[2] / t, fmt_ms(pt["device_ms"]), pt["bound_ms"], kernel,
                packed_format(lin))
    print("\n# C5 check: paper compounds ~600x FPGA area on this GEMM; the")
    print("# fixed-silicon restatement compounds MACs x bytes as counted")
    print("# above (pruning is linear; precision is linear-in-bytes — the")
    print("# quadratic multiplier shrink has no tensor-core analogue); the")
    print("# card's device_ms shows what the kernels make of it.")
    return {"csv": csv.records()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    run(device=a.device)


if __name__ == "__main__":
    main()

"""The paper's §III-D batch-job workflow: sweep the full design space
(kernel x size x sparsity x precision) and emit one CSV row per
configuration (port of `benchmarks/batch_sweep.py`).

The default mode is the analytic resource model (800 rows, byte for byte
the JAX package's). `--compile` adds each point's MACs counted on its
plain path (`analysis.cost.count` over the training-time apply on the
CPU), where the JAX package lowers and compiles every point and reads the
HLO's MACs.

  PYTHONPATH=src python -m repro_torch.figures.batch_sweep \
      [--out results/kratos_design_space.csv] [--compile]
"""

from __future__ import annotations

import argparse
import os

from repro_torch.core import bench_specs as BS

HEADER = ["kernel", "unroll", "size", "sparsity", "bits",
          "dense_macs", "effective_macs", "mac_fraction",
          "weight_bytes", "weight_bytes_fraction", "mxu_rate",
          "ops_per_invocation"]


def design_space(counted: bool = False) -> str:
    """The CSV text: a header and one row per design point."""
    header = HEADER + (["hlo_macs"] if counted else [])
    rows = [",".join(header)]
    for base in BS.TABLE_II:
        for spec in BS.sweep(base):
            r = spec.resource_report()
            row = [spec.kernel, spec.unroll, spec.size,
                   f"{spec.sparsity:g}", str(spec.bits or 16),
                   f"{r['dense_macs']:g}", f"{r['effective_macs']:g}",
                   f"{r['mac_fraction']:g}", f"{r['weight_bytes']:g}",
                   f"{r['weight_bytes_fraction']:g}", f"{r['mxu_rate']:g}",
                   str(spec.ops_per_invocation())]
            if counted:
                from repro_torch.analysis.cost import count
                from repro_torch.figures.common import generator
                params, x, fn = BS.instantiate(
                    spec, generator=generator("cpu"), device="cpu")
                row.append(f"{count(fn, params, x)['macs']:g}")
            rows.append(",".join(row))
    return "\n".join(rows) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/kratos_design_space.csv")
    ap.add_argument("--compile", action="store_true")
    a = ap.parse_args(argv)
    out = design_space(counted=a.compile)
    if os.path.dirname(a.out):
        os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        f.write(out)
    print(f"wrote {out.count(chr(10)) - 1} design points to {a.out}")


if __name__ == "__main__":
    main()

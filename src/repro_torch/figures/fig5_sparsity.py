"""Fig. 5 reproduction: resource utilization vs sparsity (port of
`benchmarks/fig5_sparsity.py`).

Paper claim (C1): the multiply-adder-tree kernels (gemmt / conv1d / conv2d)
show ~linear ALM reduction with sparsity; the systolic gemms barely improves
(-46%/-31% at 0.9 sparsity) because its structural registers cannot prune.

Restated on the card: `hlo_macs` are the MACs counted on each point's
plain path (the training-time apply: the tree gathers only kept blocks,
so its count falls linearly; the systolic point multiplies a masked dense
weight at every sparsity). `device_ms` times the packed point on the
hand-written kernels, `bound_ms` is its least time at the H100's peaks.

  PYTHONPATH=src python -m repro_torch.figures.fig5_sparsity \
      [--kernels k1,k2] [--full] [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.core import bench_specs as BS
from repro_torch.figures.common import CSV, fmt_ms, point, require_device

DEFAULT = ("gemmt-RP-S", "gemmt-FU-S", "gemms-RP-S",
           "conv1d-PW-S", "conv2d-PW-S", "conv2d-FU-S")
FULL = tuple(BS.BY_NAME)


def run(kernels=DEFAULT, sparsities=BS.SPARSITIES, *,
        device="cuda") -> dict:
    device = require_device(device)
    csv = CSV(["kernel", "sparsity", "hlo_macs", "mac_fraction",
               "analytic_fraction", "ideal_fraction", "device_ms",
               "bound_ms", "kernel_form", "format"])
    results, times = {}, {}
    for name in kernels:
        base = BS.BY_NAME[name]
        dense_macs = None
        fracs, ms = [], []
        for s in sparsities:
            spec = dataclasses.replace(base, sparsity=s)
            pt = point(spec, device)
            macs = pt["macs"]
            if dense_macs is None:
                dense_macs = macs
            frac = macs / dense_macs
            fracs.append(frac)
            ms.append(pt["device_ms"])
            rep = spec.resource_report()
            csv.row(name, s, macs, frac, rep["mac_fraction"], 1.0 - s,
                    fmt_ms(pt["device_ms"]), pt["bound_ms"], pt["kernel"],
                    pt["format"])
        results[name] = fracs
        times[name] = ms
    # C1 summary: linearity of tree kernels, flatness of systolic
    print("\n# C1 check (MACs counted on the plain path; the card's times "
          "in device_ms):")
    for name, fracs in results.items():
        ideal = np.array([1.0 - s for s in sparsities])
        got = np.array(fracs)
        t0, t1 = times[name][0], times[name][-1]
        on_card = (f"; device ms {t0:.4f} -> {t1:.4f} (x{t1 / t0:.2f})"
                   if isinstance(t0, float) else "")
        if name.startswith("gemms"):
            print(f"#   {name}: frac at {sparsities[-1]:g} sparsity = "
                  f"{got[-1]:.2f} (systolic: expected ~1.0, paper FPGA saw "
                  f"0.54-0.69){on_card}")
        else:
            err = np.abs(got - ideal).max()
            print(f"#   {name}: max |frac - (1-s)| = {err:.3f} "
                  f"({'LINEAR ok' if err < 0.12 else 'NOT linear'})"
                  f"{on_card}")
    return {"csv": csv.records(), "fractions": results, "device_ms": times}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    kernels = (a.kernels.split(",") if a.kernels
               else FULL if a.full else DEFAULT)
    sp = (0.0, 0.5, 0.9) if a.quick else BS.SPARSITIES
    run(kernels, sp, device=a.device)


if __name__ == "__main__":
    main()

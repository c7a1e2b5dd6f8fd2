"""Run the paper's figures on the port: one section per table or figure
(port of `benchmarks/run.py`, without its serving section, ROADMAP.md item
12, and its dry-run roofline table, item 14).

  PYTHONPATH=src python -m repro_torch.figures.run [--quick] [--device cuda|cpu]

`--device cuda` (the default) times every point on the hand-written
kernels and refuses without a card ("no CUDA device"); `--device cpu`
prints the analytic and counted columns and `-` for every time.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

from repro_torch.core import bench_specs as BS
from repro_torch.figures import (fig1_unrolled_area, fig5_sparsity,
                                 fig6_precision, fig7_throughput,
                                 table3_tilesweep)
from repro_torch.figures.common import require_device


def section(title: str) -> None:
    print(f"\n{'=' * 72}\n== {title}\n{'=' * 72}")


def run(quick: bool = False, device="cuda") -> Dict[str, dict]:
    """Every section in order; returns each section's rows and summary."""
    device = require_device(device)
    out = {}
    section("Fig. 1 — compounding on a 64x64 GEMM (C5)")
    out["fig1"] = fig1_unrolled_area.run(device=device)
    section("Fig. 5 — utilization vs sparsity (C1)")
    out["fig5"] = fig5_sparsity.run(
        sparsities=(0.0, 0.3, 0.5, 0.7, 0.9) if quick else BS.SPARSITIES,
        device=device)
    section("Fig. 6 — utilization vs precision (C2)")
    fig6_precision.verify_packed_sizes()
    out["fig6"] = fig6_precision.run(device=device)
    section("Fig. 7 — throughput vs unroll factor (C3)")
    out["fig7"] = fig7_throughput.run(quick=quick, device=device)
    section("Table III / Fig. 8 — granularity sweep (C4)")
    out["table3"] = table3_tilesweep.run(quick=quick, device=device)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    try:
        require_device(a.device)
    except RuntimeError as e:
        raise SystemExit(f"figures.run: {e}")
    t0 = time.time()
    run(quick=a.quick, device=a.device)
    print(f"\n== figures done in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()

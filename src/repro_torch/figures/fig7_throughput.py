"""Fig. 7 reproduction: achievable rate vs input-unrolling factor (port of
`benchmarks/fig7_throughput.py`).

Paper claim (C3): fully-unrolled designs hit the device clock ceiling
(~600 MHz - 1 GHz on Arria 10); pixelwise / row-parallel designs are slower
(300-600 MHz) because of control/buffering on the input-staging path.

"fmax" has no analogue on fixed silicon; what the unroll factor buys is
how much of the output one invocation materializes. `ops_per_invocation`
is the Table I column; `hlo_macs` / `hlo_bytes` are counted on the
point's plain path (bytes: each input and output once), `bound` and
`sustained_TMACs` the roofline's at the H100's f32 peaks (the points run
f32), and `device_TMACs` the MACs over the packed point's device time on
the hand-written kernels.

  PYTHONPATH=src python -m repro_torch.figures.fig7_throughput [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.analysis.cost import roofline_seconds
from repro_torch.core import bench_specs as BS
from repro_torch.figures.common import (DASH, CSV, fmt_ms, point,
                                        require_device)
from repro_torch.launch import mesh as M


def run(sparsity=0.0, bits=None, quick: bool = False, *,
        device="cuda") -> dict:
    device = require_device(device)
    csv = CSV(["kernel", "unroll", "size", "ops_per_invocation",
               "hlo_macs", "hlo_bytes", "bound", "sustained_TMACs",
               "device_ms", "bound_ms", "device_TMACs", "kernel_form",
               "format"])
    items = list(BS.BY_NAME.items())
    if quick:
        # one spec per unroll factor keeps the C3 ordering visible
        seen, kept = set(), []
        for name, base in items:
            if base.unroll not in seen:
                seen.add(base.unroll)
                kept.append((name, base))
        items = kept
    best = {}
    for name, base in items:
        spec = dataclasses.replace(base, sparsity=sparsity, bits=bits)
        pt = point(spec, device)
        t = roofline_seconds(2 * pt["macs"], pt["bytes"], "float32")
        sustained = pt["macs"] / t["t"] / 1e12
        ms = pt["device_ms"]
        on_card = pt["macs"] / (ms * 1e-3) / 1e12 if isinstance(ms, float) \
            else DASH
        if isinstance(on_card, float):
            best[spec.unroll] = max(best.get(spec.unroll, 0.0), on_card)
        csv.row(name, spec.unroll, spec.size, spec.ops_per_invocation(),
                pt["macs"], pt["bytes"], t["bound"], sustained, fmt_ms(ms),
                pt["bound_ms"], on_card, pt["kernel"], pt["format"])
    print("\n# C3 check: fully-unrolled ('full') rows sustain the highest")
    print("# MACs/s; pixelwise rows are memory-bound by input staging —")
    print(f"# ceiling = {M.PEAK_F32_FLOPS / 2 / 1e12:.1f} TMACs/s per card "
          "(f32).")
    if best:
        print("# on the card, best TMACs/s by unroll: "
              + ", ".join(f"{u} {v:.4f}" for u, v in best.items()))
    return {"csv": csv.records(), "device_TMACs": best}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    run(quick=a.quick, device=a.device)


if __name__ == "__main__":
    main()

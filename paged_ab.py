#!/usr/bin/env python3
"""Time `chip_smoke.py`'s phase 6 of this checkout against another
checkout's, on one NVIDIA GPU.

    python3 paged_ab.py OTHER_CHECKOUT

Phase 6 serves h2o-danube-1.8b at full width and depth (phase 5's traffic,
random f32 weights from the seed) from the slab (dense) and from the page
pool (dense, w4, w8a8), each decode dispatch a CUDA-graph replay, and
traces the graphed dispatch for its device time. Each checkout runs its own
`chip_smoke.py`, package and kernels (built into that checkout's
`build/`), in a process of its own, in turns other / this / this / other,
so the two sides see the same card in one call. Prints, for each run, the
graphed wall ms, the device ms and the device ops a decode micro-step on
each side, and writes chiprun_out/paged_ab.json. Exits non-zero without a
GPU or where a side fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KEYS = ("decode_micro_step_ms", "device_ms_per_micro_step",
        "device_ops_per_micro_step")


def run_side(checkout: str, out: str) -> int:
    """One side: the checkout's phase 6, its results written to `out`."""
    import torch
    sys.path[:0] = [str(Path(checkout) / "src"), checkout]
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    _, paged = cs.phase_paged_serving(torch, card, cs.init_danube(torch))
    res = {tag: {k: r[k] for k in ("decode_micro_step_ms",
                                   "device_ops_per_micro_step")}
           for tag, r in paged.items() if isinstance(r, dict)
           and "decode_micro_step_ms" in r}
    for tag in res:
        r = paged[tag]
        res[tag]["device_ms_per_micro_step"] = [
            g + o for g, o in zip(r["gemm_device_ms_per_micro_step"],
                                  r["non_gemm_device_ms_per_micro_step"])]
    Path(out).write_text(json.dumps({"card": card, "runs": res}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--side"]:
        return run_side(*sys.argv[2:4])
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    sides = {"other": other, "this": str(ROOT)}
    got = {"other": [], "this": []}
    for i, side in enumerate(("other", "this", "this", "other")):
        path = out / f"paged_ab_{i}.json"
        rc = subprocess.call([sys.executable, __file__, "--side",
                              sides[side], str(path)])
        if rc:
            print(f"paged_ab: the {side} side failed ({rc})", file=sys.stderr)
            return 1
        got[side].append(json.loads(path.read_text()))
    card = got["this"][0]["card"]
    table = {}
    for tag in got["this"][0]["runs"]:
        table[tag] = {}
        for key in KEYS:
            vals = {side: [v for g in got[side]
                           for v in _flat(g["runs"][tag][key])]
                    for side in sides}
            med = {side: statistics.median(v) for side, v in vals.items()}
            table[tag][key] = dict(vals, ratio=med["this"] / med["other"])
            print(f"{tag:11s} {key:27s} [{card}] other {vals['other']} "
                  f"this {vals['this']} (median ratio this / other "
                  f"{med['this'] / med['other']:.4f})", flush=True)
    (out / "paged_ab.json").write_text(json.dumps(
        {"card": card, "other": other, "runs": table}, indent=1))
    return 0


def _flat(v):
    return v if isinstance(v, list) else [v]


if __name__ == "__main__":
    sys.exit(main())

"""Roofline attribution: ledger counts x static costs x trace wall-time
(port of `repro.analysis.roofline`).

The three observability sources each answer one question:

  * `serve.ledger` (device-resident counters): how much of the dense work
    was ineffectual this dispatch (activation zeros, dead k-blocks,
    effective-vs-dense FLOPs/bytes), measured on the step clock;
  * a static cost (the JAX package's `analysis.hlo.analyze`; in the port
    `analysis.cost.count`): what one dispatch must execute, independent
    of data;
  * `serve.trace` dispatch events: how long each dispatch took.

This module joins them. `roofline_point` classifies one (flops, bytes,
wall) triple against a machine roof; `dispatch_rooflines` joins a trace
event stream's per-step wall durations with the ledger's per-step
effective fractions to place both the dense point and the effective
point on the same roof; `replica_roofline` does the same once per replica
from drained totals. The port's `Tracer` exports the JAX package's event
format, so both read the port's own exports unchanged.

Plain dict / float code, the JAX package's number for number. `Peaks()`
keeps its modest CPU-class defaults; the card's roof is
`analysis.cost.PEAKS[dtype]` (the H100 data-sheet peaks of `launch.mesh`),
on which `analysis.cost.roofline_seconds` computes every bound of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Machine roof. Defaults are deliberately modest CPU-class numbers so
    unit tests and laptop runs produce sane utilizations; real runs pass
    measured peaks (e.g. from a dense GEMM sweep or the chip datasheet)."""

    peak_flops: float = 2.0e11     # flop/s
    peak_bw: float = 5.0e10        # bytes/s

    @property
    def ridge(self) -> float:
        """Arithmetic intensity (flop/byte) where the roofs intersect."""
        return self.peak_flops / self.peak_bw


def roofline_point(flops: float, bytes_: float, wall_s: float,
                   peaks: Peaks = Peaks()) -> Dict[str, float]:
    """Classify one workload sample against the roof.

    Returns intensity (flop/byte), achieved flop/s and bytes/s, the roof
    at that intensity, which resource bounds it, and utilization =
    achieved / roof (in the bounding resource).
    """
    bytes_ = max(float(bytes_), 1.0)
    wall_s = max(float(wall_s), 1e-12)
    flops = max(float(flops), 0.0)
    intensity = flops / bytes_
    achieved_flops = flops / wall_s
    achieved_bw = bytes_ / wall_s
    roof = min(peaks.peak_flops, intensity * peaks.peak_bw)
    bound = "compute" if intensity >= peaks.ridge else "memory"
    if bound == "compute":
        utilization = achieved_flops / peaks.peak_flops
    else:
        utilization = achieved_bw / peaks.peak_bw
    return {
        "intensity": intensity,
        "achieved_flops": achieved_flops,
        "achieved_bw": achieved_bw,
        "roof_flops": roof,
        "bound": bound,
        "utilization": utilization,
    }


def _index_ledger(events: Iterable[Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
    return {int(ev["step"]): ev for ev in events if ev.get("ev") == "ledger"}


def dispatch_rooflines(events: Iterable[Dict[str, Any]],
                       hlo_cost: Optional[Dict[str, Any]] = None,
                       peaks: Peaks = Peaks()) -> List[Dict[str, Any]]:
    """Per-dispatch roofline rows from one tracer's event list.

    events: `Tracer.export()["events"]` (or the parsed JSONL) — the join
    key is the step clock: each "decode"/"spec" dispatch event is matched
    with the "ledger" event drained at the same step.

    hlo_cost: a static `{flops, bytes}` cost of one dispatch (the JAX
    package's `analysis.hlo.analyze`, the port's `analysis.cost.count`;
    the name is kept) — supplies the static per-dispatch bytes (and a
    FLOPs cross-check for the ledger's dense count). Without it, bytes
    fall back to the ledger's own dense-bytes counter scaled per dispatch.

    Each row carries a `dense` point (what ran) and an `effective` point
    (the same wall clock at ledger-measured effective FLOPs/bytes): the
    utilization gap between them is the headroom an activation-skip
    kernel could claim.
    """
    evs = list(events)
    ledger_by_step = _index_ledger(evs)
    rows: List[Dict[str, Any]] = []
    for ev in evs:
        if ev.get("ev") not in ("decode", "spec"):
            continue
        step = int(ev["step"])
        led = ledger_by_step.get(step)
        if led is None:
            continue
        wall = float(ev.get("dur", 0.0))
        flops_dense = float(led["flops_dense"])
        flops_eff = float(led["flops_eff"])
        if hlo_cost is not None:
            bytes_dense = float(hlo_cost["bytes"])
            static_flops = float(hlo_cost["flops"])
        else:
            bytes_dense = flops_dense  # intensity-1 fallback, labeled below
            static_flops = 0.0
        eff_frac = float(led.get("eff_flop_frac", 1.0))
        bytes_eff = bytes_dense * eff_frac
        rows.append({
            "step": step,
            "kind": ev["ev"],
            "wall_s": wall,
            "flops_dense": flops_dense,
            "flops_effective": flops_eff,
            "static_flops": static_flops,
            "bytes_source": "hlo" if hlo_cost is not None else "ledger",
            "zero_frac": float(led.get("zero_frac", 0.0)),
            "dead_kblock_frac": float(led.get("dead_frac", 0.0)),
            "dense": roofline_point(flops_dense, bytes_dense, wall, peaks),
            "effective": roofline_point(flops_eff, bytes_eff, wall, peaks),
        })
    return rows


def replica_roofline(summary: Dict[str, Any], wall_s: float,
                     hlo_cost: Optional[Dict[str, Any]] = None,
                     n_dispatches: int = 1,
                     peaks: Peaks = Peaks()) -> Dict[str, Any]:
    """Whole-replica roofline from `LedgerSink.summary()` totals.

    summary: drained cumulative totals (flops_dense / flops_effective /
    bytes_dense / bytes_effective). wall_s: the replica's decode wall
    time over the same window (sum of dispatch durs, or bench wall).
    hlo_cost x n_dispatches supplies static bytes when the per-probe byte
    model is not what you want on the memory axis.
    """
    fd = float(summary.get("flops_dense", 0.0))
    fe = float(summary.get("flops_effective", 0.0))
    if hlo_cost is not None:
        bd = float(hlo_cost["bytes"]) * max(1, int(n_dispatches))
        be = bd * (fe / fd if fd > 0 else 1.0)
    else:
        bd = float(summary.get("bytes_dense", 0.0))
        be = float(summary.get("bytes_effective", 0.0))
    out = {
        "wall_s": float(wall_s),
        "flops_dense": fd,
        "flops_effective": fe,
        "bytes_dense": bd,
        "bytes_effective": be,
        "effective_flop_fraction": fe / fd if fd > 0 else 1.0,
        "dense": roofline_point(fd, bd, wall_s, peaks),
        "effective": roofline_point(fe, be, wall_s, peaks),
    }
    # upper bound on an activation-skip kernel's speedup: the work ratio in
    # whichever resource bounds the dense point on this roof
    if out["dense"]["bound"] == "compute":
        out["skip_speedup_bound"] = fd / fe if fe > 0 else 1.0
    else:
        out["skip_speedup_bound"] = bd / be if be > 0 else 1.0
    return out

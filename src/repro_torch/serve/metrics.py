"""Serving metrics: throughput, latency percentiles, occupancy, host syncs
(the slab-engine subset of `repro.serve.metrics`, same report keys).

Two clocks: wall seconds (time.perf_counter, monotonic) and engine steps
(one slab decode micro-step per step). `decode_steps` counts DISPATCHES (K
micro-steps each); `host_syncs` counts host<->device crossings by kind —
the fused decode loop costs exactly one per dispatch (the (K, B) token
block), prefill one per admission (the first token).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100])."""
    if not values:
        return float("nan")
    xs = sorted(values)
    rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[rank])


@dataclasses.dataclass
class RequestRecord:
    request_id: int
    arrival_step: int
    start_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    n_prompt: int = 0
    n_generated: int = 0
    submit_mono: float = 0.0        # perf_counter at submit
    first_token_time: float = 0.0
    finish_time: float = 0.0


class ServeMetrics:
    """Engine-side counters; one instance per engine run."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()
        self.decode_steps = 0                 # dispatches (K micro-steps each)
        self.micro_steps = 0
        self.idle_steps = 0
        self.prefills = 0
        self.tokens_generated = 0
        self.rejected = 0
        self.host_syncs: Dict[str, int] = {"decode": 0, "prefill": 0}
        self.occupancy: List[float] = []
        self.records: Dict[int, RequestRecord] = {}

    def on_submit(self, request_id: int, arrival_step: int, n_prompt: int) -> None:
        self.records[request_id] = RequestRecord(
            request_id=request_id, arrival_step=arrival_step,
            n_prompt=n_prompt, submit_mono=time.perf_counter())

    def on_start(self, request_id: int, step: int) -> None:
        self.records[request_id].start_step = step
        self.prefills += 1

    def on_token(self, request_id: int, step: int) -> None:
        rec = self.records[request_id]
        if rec.first_token_step < 0:
            rec.first_token_step = step
            rec.first_token_time = time.perf_counter()
        rec.n_generated += 1
        self.tokens_generated += 1

    def on_finish(self, request_id: int, step: int) -> None:
        rec = self.records[request_id]
        rec.finish_step = step
        rec.finish_time = time.perf_counter()

    def on_decode_step(self, n_active: int, n_slots: int,
                       micro_steps: int = 1) -> None:
        self.decode_steps += 1
        self.micro_steps += micro_steps
        self.occupancy.append(n_active / max(1, n_slots))

    def on_idle_step(self) -> None:
        self.idle_steps += 1

    def on_reject(self) -> None:
        self.rejected += 1

    def on_host_sync(self, kind: str, n: int = 1) -> None:
        self.host_syncs[kind] = self.host_syncs.get(kind, 0) + n

    def report(self) -> Dict[str, float]:
        elapsed = max(time.perf_counter() - self.t0, 1e-9)
        per_dispatch = self.tokens_generated / max(1, self.decode_steps)
        done = [r for r in self.records.values() if r.finish_step >= 0]
        lat_steps = [float(r.finish_step - r.arrival_step) for r in done]
        ttft_steps = [float(r.first_token_step - r.arrival_step)
                      for r in done if r.first_token_step >= 0]
        lat_wall = [r.finish_time - r.submit_mono for r in done]
        decoded = max(0, self.tokens_generated - self.prefills)
        return {
            "requests_completed": float(len(done)),
            "tokens_generated": float(self.tokens_generated),
            "rejected": float(self.rejected),
            "decode_steps": float(self.decode_steps),
            "micro_steps": float(self.micro_steps),
            "idle_steps": float(self.idle_steps),
            "host_syncs_decode": float(self.host_syncs.get("decode", 0)),
            "host_syncs_prefill": float(self.host_syncs.get("prefill", 0)),
            "host_syncs_per_token": self.host_syncs.get("decode", 0)
            / max(1, decoded),
            "wall_seconds": elapsed,
            "tok_per_s": self.tokens_generated / elapsed,
            "tokens_per_step": per_dispatch,
            "tokens_per_dispatch": per_dispatch,
            "mean_occupancy": (sum(self.occupancy) / len(self.occupancy))
            if self.occupancy else 0.0,
            "latency_steps_p50": percentile(lat_steps, 50),
            "latency_steps_p99": percentile(lat_steps, 99),
            "latency_s_p50": percentile(lat_wall, 50),
            "latency_s_p99": percentile(lat_wall, 99),
            "ttft_steps_p50": percentile(ttft_steps, 50),
            "ttft_steps_p99": percentile(ttft_steps, 99),
        }

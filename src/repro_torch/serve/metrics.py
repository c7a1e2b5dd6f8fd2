"""Serving metrics: throughput, latency percentiles, occupancy, host syncs,
prefix reuse, page occupancy, speculative acceptance, QoS tier churn,
shedding, failover, the ineffectual-work ledger, the per-tier quality
probe and trace ring-buffer losses (port of `repro.serve.metrics`, the
same report keys; `aggregate` pools replicas for serve.router, and
`to_payload` / `from_payload` carry one engine's counters across a fleet's
process boundary for serve.control).

Two clocks: wall seconds (time.perf_counter, monotonic) and engine steps
(one slab decode micro-step per step); a request's `submit_time`
(time.time) is a log anchor only, which no interval subtracts.
`decode_steps` counts DISPATCHES (K micro-steps each); `host_syncs`
counts host<->device crossings by kind — the fused decode loop costs
exactly one per dispatch (the (K, B) token block), prefill one per
admission (the first token), and the quality probe two per probed
admission under its own kind, so `host_syncs_decode` stays the dispatch
count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch


def _plain(v):
    """`v` with every tensor turned into plain Python numbers (a 0-d one
    into a scalar), containers recursively: what `json.dumps` takes."""
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


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
    submit_time: float = 0.0        # wall clock (time.time), for logs
    #                                 only: never subtracted
    first_token_time: float = 0.0
    finish_time: float = 0.0
    submit_mono: float = 0.0        # perf_counter at submit


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
        # paged KV + prefix reuse (serve.paging)
        self.prefix_lookups = 0               # paged admissions
        self.prefix_hits = 0                  # ... that matched a prefix
        self.prefill_tokens_skipped = 0       # prompt tokens never prefilled
        self.prefill_tokens_computed = 0      # prompt tokens prefilled
        self.pool_waits = 0                   # admissions requeued on pages
        self.page_samples: List[int] = []     # pages_in_use per dispatch
        self.page_capacity = 0                # usable pages in the pool
        self.conversation_prefix_hits = 0     # admissions resuming a chat
        self.conversation_tokens_reused = 0   # ... tokens matched there
        # bytes a gather/scatter paged decode would have moved per
        # dispatch, summed (0 on the slab)
        self.gather_bytes_avoided = 0
        # speculative decode (serve.speculative)
        self.spec_dispatches = 0              # propose-then-verify cycles
        self.draft_proposed = 0               # draft tokens offered
        self.draft_accepted = 0               # ... committed by the verify
        self.draft_flop_fraction = 0.0        # analytic draft/target FLOPs
        self.slot_acceptance: Dict[int, List[int]] = {}   # slot: [acc, prop]
        # resilience (serve.qos)
        self.tier_demotions = 0               # moves to a cheaper tier
        self.tier_promotions = 0              # ... back toward tier 0
        self.shed = 0                         # requests ended "shed"
        self.deadline_missed = 0              # ... on a deadline
        self.shed_pool_pressure = 0           # ... past pool_wait_retries
        self.failovers = 0                    # requests re-admitted HERE off
        #                                       a dead replica (serve.router)
        # ineffectual-work ledger (serve.ledger): exact integer counts
        # drained from the device matrix, summed in float64
        self.ledger_dispatches = 0            # dispatches with a drain
        self.act_probe_elems = 0.0            # activation elements probed
        self.act_zeros = 0.0                  # exact zeros among them
        self.act_near_zeros = 0.0             # |x| <= threshold
        self.act_groups = 0.0                 # histogram groups probed
        self.act_kblocks = 0.0                # k-blocks examined
        self.act_dead_kblocks = 0.0           # ... entirely near-zero
        self.flops_dense = 0.0                # dense FLOPs at probed GEMMs
        self.flops_effective = 0.0            # minus the dead-k-block share
        self.bytes_dense = 0.0
        self.bytes_effective = 0.0
        # per-tier quality probe: tier -> [n, top-1 matches, mad sum]
        self.quality_probes = 0
        self.quality: Dict[int, List[float]] = {}
        # the tracer's cumulative ring-buffer drop count, mirrored by the
        # engine after every dispatch
        self.trace_dropped = 0

    def on_submit(self, request_id: int, arrival_step: int, n_prompt: int) -> None:
        self.records[request_id] = RequestRecord(
            request_id=request_id, arrival_step=arrival_step,
            n_prompt=n_prompt, submit_time=time.time(),
            submit_mono=time.perf_counter())

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

    def on_spec_dispatch(self, proposed: int, accepted: int) -> None:
        """One propose-then-verify cycle: `proposed` draft tokens offered
        across live slots, `accepted` of them committed. Rolled-back tokens
        (proposed - accepted) cost draft work and an index rewind, no host
        traffic."""
        self.spec_dispatches += 1
        self.draft_proposed += proposed
        self.draft_accepted += accepted

    def on_slot_speculation(self, slot: int, accepted: int,
                            proposed: int) -> None:
        """Per-slot acceptance accounting."""
        acc = self.slot_acceptance.setdefault(slot, [0, 0])
        acc[0] += accepted
        acc[1] += proposed

    def on_prefix(self, matched: int, n_prompt: int) -> None:
        """One paged admission: `matched` of `n_prompt` prompt tokens came
        from shared prefix pages (their prefill was skipped)."""
        self.prefix_lookups += 1
        self.prefix_hits += int(matched > 0)
        self.prefill_tokens_skipped += matched
        self.prefill_tokens_computed += n_prompt - matched

    def on_gather_avoided(self, n_bytes: int) -> None:
        """One page-table-native decode dispatch: `n_bytes` is what a
        gather/scatter decode would have moved (2x the slab view of the
        paged leaves: gathered in, scattered back)."""
        self.gather_bytes_avoided += n_bytes

    def on_conversation_hit(self, matched: int) -> None:
        """A paged admission whose match ran through pages a finished
        request published from its generated tokens (a chat resuming its
        prior turn); `matched` tokens skipped prefill."""
        self.conversation_prefix_hits += 1
        self.conversation_tokens_reused += matched

    def on_pool_wait(self) -> None:
        """An admission bounced off page pressure and was requeued."""
        self.pool_waits += 1

    def on_tier_change(self, old_tier: int, new_tier: int) -> None:
        """The engine swapped its packed tier (serve.qos): a higher tier
        index is a demotion, a lower one a promotion."""
        if new_tier > old_tier:
            self.tier_demotions += 1
        elif new_tier < old_tier:
            self.tier_promotions += 1

    def on_shed(self, reason: str) -> None:
        """A request ended "shed" instead of "done": 'deadline', 'pool'
        (past the pool_wait_retries cap), 'failover' (no replica could
        re-home it) or 'cancel'."""
        self.shed += 1
        if reason == "deadline":
            self.deadline_missed += 1
        elif reason == "pool":
            self.shed_pool_pressure += 1

    def on_failover(self) -> None:
        """A request evacuated off a dead replica was re-admitted here
        (counted on the destination, so fleet sums stay exact)."""
        self.failovers += 1

    def on_ledger(self, *, elems: float, zeros: float, near: float,
                  groups: float, kblocks: float, dead_kblocks: float,
                  flops_dense: float, flops_eff: float, bytes_dense: float,
                  bytes_eff: float) -> None:
        """One drained dispatch delta of the ineffectual-work ledger
        (serve.ledger `LedgerSink.on_drain`)."""
        self.ledger_dispatches += 1
        self.act_probe_elems += elems
        self.act_zeros += zeros
        self.act_near_zeros += near
        self.act_groups += groups
        self.act_kblocks += kblocks
        self.act_dead_kblocks += dead_kblocks
        self.flops_dense += flops_dense
        self.flops_effective += flops_eff
        self.bytes_dense += bytes_dense
        self.bytes_effective += bytes_eff

    def on_quality_probe(self, tier: int, top1: bool, mad: float) -> None:
        """One shadow-prefill sample against tier 0 (serve.ledger): top-1
        agreement and the mean |logit difference| of the probed column."""
        self.quality_probes += 1
        q = self.quality.setdefault(tier, [0.0, 0.0, 0.0])
        q[0] += 1.0
        q[1] += 1.0 if top1 else 0.0
        q[2] += mad

    def quality_by_tier(self) -> Dict[int, Dict[str, float]]:
        """Per tier: probes, top-1 agreement rate against tier 0, mean
        |logit difference|."""
        return {t: {"probes": q[0],
                    "top1_rate": q[1] / max(1.0, q[0]),
                    "logit_mad": q[2] / max(1.0, q[0])}
                for t, q in sorted(self.quality.items())}

    def on_pages(self, in_use: int, capacity: int) -> None:
        """Per-dispatch page-pool gauge (pages referenced by live slots or
        retained by the prefix index, out of the usable pool)."""
        self.page_samples.append(in_use)
        self.page_capacity = capacity

    # -- cross-process transport (serve.control) ----------------------------

    def to_payload(self) -> Dict:
        """JSON-safe snapshot of every counter and record, so a fleet
        worker can ship its metrics through the control plane and the
        coordinator can rebuild ServeMetrics objects and reuse `aggregate`
        unchanged. Monotonic anchors don't cross processes: only the
        elapsed interval travels; `from_payload` re-bases it on the
        receiver's own perf_counter. A tensor anywhere becomes plain
        Python numbers."""
        d = {k: _plain(v) for k, v in self.__dict__.items() if k != "t0"}
        d["elapsed"] = time.perf_counter() - self.t0
        d["records"] = {str(rid): _plain(dataclasses.asdict(r))
                        for rid, r in self.records.items()}
        d["quality"] = {str(t): _plain(list(q))
                        for t, q in self.quality.items()}
        d["slot_acceptance"] = {str(s): _plain(list(a))
                                for s, a in self.slot_acceptance.items()}
        return d

    @classmethod
    def from_payload(cls, payload: Dict) -> "ServeMetrics":
        """Rebuild a ServeMetrics from `to_payload` output. Per-request
        monotonic timestamps are from the SENDER's clock, useless here, so
        wall intervals are zeroed; the step-clock fields (everything the
        deterministic gates read) survive exactly."""
        m = cls()
        m.t0 = time.perf_counter() - float(payload.get("elapsed", 0.0))
        rec_fields = {f.name for f in dataclasses.fields(RequestRecord)}
        for k, v in payload.items():
            if k in ("elapsed", "records", "quality", "slot_acceptance"):
                continue
            if hasattr(m, k):
                setattr(m, k, v)
        for rid, rd in payload.get("records", {}).items():
            rec = RequestRecord(**{k: v for k, v in rd.items()
                                   if k in rec_fields})
            rec.submit_mono = rec.first_token_time = rec.finish_time = 0.0
            m.records[int(rid)] = rec
        m.quality = {int(t): list(q)
                     for t, q in payload.get("quality", {}).items()}
        m.slot_acceptance = {int(s): list(a) for s, a in
                             payload.get("slot_acceptance", {}).items()}
        return m

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
            "host_syncs_quality": float(self.host_syncs.get("quality", 0)),
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
            # paged KV + prefix reuse
            "prefix_hit_rate": self.prefix_hits
            / max(1, self.prefix_lookups),
            "prefill_tokens_skipped": float(self.prefill_tokens_skipped),
            "prefill_skip_fraction": self.prefill_tokens_skipped
            / max(1, self.prefill_tokens_skipped
                  + self.prefill_tokens_computed),
            "pool_waits": float(self.pool_waits),
            "gather_bytes_avoided": float(self.gather_bytes_avoided),
            "conversation_prefix_hits": float(self.conversation_prefix_hits),
            "conversation_tokens_reused": float(
                self.conversation_tokens_reused),
            "pages_in_use": (sum(self.page_samples)
                             / len(self.page_samples))
            if self.page_samples else 0.0,
            "page_occupancy": (sum(self.page_samples)
                               / (len(self.page_samples)
                                  * self.page_capacity))
            if (self.page_samples and self.page_capacity) else 0.0,
            # speculative decode: acceptance, rollback, cost ratio
            "spec_dispatches": float(self.spec_dispatches),
            "draft_proposed": float(self.draft_proposed),
            "draft_accepted": float(self.draft_accepted),
            "draft_rolled_back": float(self.draft_proposed
                                       - self.draft_accepted),
            "acceptance_rate": self.draft_accepted
            / max(1, self.draft_proposed),
            "draft_verify_flop_ratio": self.draft_flop_fraction,
            # resilience: QoS tier churn, shedding
            "tier_demotions": float(self.tier_demotions),
            "tier_promotions": float(self.tier_promotions),
            "shed": float(self.shed),
            "deadline_missed": float(self.deadline_missed),
            "shed_pool_pressure": float(self.shed_pool_pressure),
            "failovers": float(self.failovers),
            # ineffectual-work ledger: exact counters, derived fractions
            "ledger_dispatches": float(self.ledger_dispatches),
            "act_probe_elems": float(self.act_probe_elems),
            "act_zeros": float(self.act_zeros),
            "act_near_zeros": float(self.act_near_zeros),
            "act_groups": float(self.act_groups),
            "act_kblocks": float(self.act_kblocks),
            "act_dead_kblocks": float(self.act_dead_kblocks),
            "act_zero_fraction": self.act_zeros
            / max(1.0, self.act_probe_elems),
            "act_near_zero_fraction": self.act_near_zeros
            / max(1.0, self.act_probe_elems),
            "dead_kblock_fraction": self.act_dead_kblocks
            / max(1.0, self.act_kblocks),
            "flops_dense": float(self.flops_dense),
            "flops_effective": float(self.flops_effective),
            "effective_flop_fraction": self.flops_effective
            / max(1.0, self.flops_dense),
            "bytes_dense": float(self.bytes_dense),
            "bytes_effective": float(self.bytes_effective),
            # the per-tier quality probe, pooled (per tier: quality_by_tier)
            "quality_probes": float(self.quality_probes),
            "quality_top1_rate": sum(q[1] for q in self.quality.values())
            / max(1.0, float(self.quality_probes)),
            "quality_logit_mad": sum(q[2] for q in self.quality.values())
            / max(1.0, float(self.quality_probes)),
            # trace ring-buffer losses
            "trace_dropped": float(self.trace_dropped),
        }

    @staticmethod
    def aggregate(metrics_list: List["ServeMetrics"]) -> Dict[str, float]:
        """Cross-replica aggregate (serve.router): counters SUM, latency
        percentiles pool the union of per-request records (not a mean of
        per-replica percentiles — p99 of a fleet is a fleet-level quantile),
        occupancy is dispatch-weighted. Step-clock rates are left to the
        router, which owns the shared clock (tokens_per_router_step).

        The returned key set is exactly `report()`'s plus the fleet-only
        `n_replicas`: a reader of one engine's report finds every key in
        the fleet's."""
        done = [r for m in metrics_list for r in m.records.values()
                if r.finish_step >= 0]
        lat_steps = [float(r.finish_step - r.arrival_step) for r in done]
        ttft_steps = [float(r.first_token_step - r.arrival_step)
                      for r in done if r.first_token_step >= 0]
        lat_wall = [r.finish_time - r.submit_mono for r in done]
        dispatches = sum(m.decode_steps for m in metrics_list)
        occ_num = sum(sum(m.occupancy) for m in metrics_list)
        occ_den = sum(len(m.occupancy) for m in metrics_list)
        tokens = sum(m.tokens_generated for m in metrics_list)
        decoded = max(0, tokens - sum(m.prefills for m in metrics_list))
        syncs_d = sum(m.host_syncs.get("decode", 0) for m in metrics_list)
        proposed = sum(m.draft_proposed for m in metrics_list)
        accepted = sum(m.draft_accepted for m in metrics_list)
        # fleet-pooled prefix/paging: hit rate over the union of paged
        # admissions and page occupancy dispatch-weighted against each
        # replica's own capacity — same pooling discipline as acceptance
        # (never a mean of per-replica rates)
        lookups = sum(m.prefix_lookups for m in metrics_list)
        hits = sum(m.prefix_hits for m in metrics_list)
        skipped = sum(m.prefill_tokens_skipped for m in metrics_list)
        computed = sum(m.prefill_tokens_computed for m in metrics_list)
        page_num = sum(sum(m.page_samples) for m in metrics_list)
        page_den = sum(len(m.page_samples) for m in metrics_list)
        page_cap = sum(len(m.page_samples) * m.page_capacity
                       for m in metrics_list)
        elapsed = max(max((time.perf_counter() - m.t0 for m in metrics_list),
                          default=0.0), 1e-9)
        tokens_per_dispatch = tokens / max(1, dispatches)
        # fleet-pooled ledger: counters sum; fractions re-derive from the
        # pooled numerators/denominators (never a mean of per-replica rates)
        led_elems = sum(m.act_probe_elems for m in metrics_list)
        led_zeros = sum(m.act_zeros for m in metrics_list)
        led_near = sum(m.act_near_zeros for m in metrics_list)
        led_kb = sum(m.act_kblocks for m in metrics_list)
        led_dead = sum(m.act_dead_kblocks for m in metrics_list)
        led_fd = sum(m.flops_dense for m in metrics_list)
        led_fe = sum(m.flops_effective for m in metrics_list)
        qn = sum(float(m.quality_probes) for m in metrics_list)
        q_top1 = sum(q[1] for m in metrics_list
                     for q in m.quality.values())
        q_mad = sum(q[2] for m in metrics_list
                    for q in m.quality.values())
        return {
            "n_replicas": float(len(metrics_list)),
            "requests_completed": float(len(done)),
            "tokens_generated": float(tokens),
            "rejected": float(sum(m.rejected for m in metrics_list)),
            "decode_steps": float(dispatches),
            "micro_steps": float(sum(m.micro_steps for m in metrics_list)),
            "idle_steps": float(sum(m.idle_steps for m in metrics_list)),
            "host_syncs_decode": float(syncs_d),
            "host_syncs_prefill": float(sum(
                m.host_syncs.get("prefill", 0) for m in metrics_list)),
            "host_syncs_quality": float(sum(
                m.host_syncs.get("quality", 0) for m in metrics_list)),
            "host_syncs_per_token": syncs_d / max(1, decoded),
            "wall_seconds": elapsed,
            "tok_per_s": tokens / elapsed,
            # aliased as in report()
            "tokens_per_step": tokens_per_dispatch,
            "tokens_per_dispatch": tokens_per_dispatch,
            # fleet-pooled speculation: acceptance is accepted/proposed over
            # the union of cycles, not a mean of per-replica rates
            "spec_dispatches": float(sum(m.spec_dispatches
                                         for m in metrics_list)),
            "draft_proposed": float(proposed),
            "draft_accepted": float(accepted),
            "draft_rolled_back": float(proposed - accepted),
            "acceptance_rate": accepted / max(1, proposed),
            # proposal-weighted across replicas (0.0 when no one speculates)
            "draft_verify_flop_ratio": sum(
                m.draft_flop_fraction * m.draft_proposed
                for m in metrics_list) / max(1, proposed),
            # fleet-pooled paged/prefix metrics
            "prefix_hit_rate": hits / max(1, lookups),
            "prefill_tokens_skipped": float(skipped),
            "prefill_skip_fraction": skipped / max(1, skipped + computed),
            "pool_waits": float(sum(m.pool_waits for m in metrics_list)),
            "gather_bytes_avoided": float(sum(
                m.gather_bytes_avoided for m in metrics_list)),
            "conversation_prefix_hits": float(sum(
                m.conversation_prefix_hits for m in metrics_list)),
            "conversation_tokens_reused": float(sum(
                m.conversation_tokens_reused for m in metrics_list)),
            "pages_in_use": page_num / page_den if page_den else 0.0,
            "page_occupancy": page_num / page_cap if page_cap else 0.0,
            # resilience counters sum exactly (failovers are counted on the
            # destination replica only, shed on the shedding replica only)
            "tier_demotions": float(sum(m.tier_demotions
                                        for m in metrics_list)),
            "tier_promotions": float(sum(m.tier_promotions
                                         for m in metrics_list)),
            "shed": float(sum(m.shed for m in metrics_list)),
            "deadline_missed": float(sum(m.deadline_missed
                                         for m in metrics_list)),
            "shed_pool_pressure": float(sum(m.shed_pool_pressure
                                            for m in metrics_list)),
            "failovers": float(sum(m.failovers for m in metrics_list)),
            # fleet-pooled ineffectual-work ledger
            "ledger_dispatches": float(sum(m.ledger_dispatches
                                           for m in metrics_list)),
            "act_probe_elems": float(led_elems),
            "act_zeros": float(led_zeros),
            "act_near_zeros": float(led_near),
            "act_groups": float(sum(m.act_groups for m in metrics_list)),
            "act_kblocks": float(led_kb),
            "act_dead_kblocks": float(led_dead),
            "act_zero_fraction": led_zeros / max(1.0, led_elems),
            "act_near_zero_fraction": led_near / max(1.0, led_elems),
            "dead_kblock_fraction": led_dead / max(1.0, led_kb),
            "flops_dense": float(led_fd),
            "flops_effective": float(led_fe),
            "effective_flop_fraction": led_fe / max(1.0, led_fd),
            "bytes_dense": float(sum(m.bytes_dense for m in metrics_list)),
            "bytes_effective": float(sum(m.bytes_effective
                                         for m in metrics_list)),
            "quality_probes": float(qn),
            "quality_top1_rate": q_top1 / max(1.0, qn),
            "quality_logit_mad": q_mad / max(1.0, qn),
            "trace_dropped": float(sum(m.trace_dropped
                                       for m in metrics_list)),
            "mean_occupancy": occ_num / occ_den if occ_den else 0.0,
            "latency_steps_p50": percentile(lat_steps, 50),
            "latency_steps_p99": percentile(lat_steps, 99),
            "latency_s_p50": percentile(lat_wall, 50),
            "latency_s_p99": percentile(lat_wall, 99),
            "ttft_steps_p50": percentile(ttft_steps, 50),
            "ttft_steps_p99": percentile(ttft_steps, 99),
        }

    def format_report(self) -> str:
        r = self.report()
        spec = ""
        if self.spec_dispatches:
            spec = (f" | accept {r['acceptance_rate']:.2f} "
                    f"({int(r['draft_rolled_back'])} rolled back, "
                    f"draft/verify flops {r['draft_verify_flop_ratio']:.2f})")
        if self.prefix_lookups:
            spec += (f" | prefix hit {r['prefix_hit_rate']:.2f} "
                     f"({int(r['prefill_tokens_skipped'])} prefill toks "
                     f"skipped, pages {r['page_occupancy']:.2f} full)")
            if self.conversation_prefix_hits:
                spec += (f" | conv hits {self.conversation_prefix_hits} "
                         f"({self.conversation_tokens_reused} toks reused)")
            if self.gather_bytes_avoided:
                spec += (f" | gather avoided "
                         f"{self.gather_bytes_avoided / 1e6:.1f} MB")
        if self.ledger_dispatches:
            spec += (f" | act zeros {r['act_zero_fraction']:.2f} "
                     f"(dead k-blocks {r['dead_kblock_fraction']:.2f}, "
                     f"eff flops {r['effective_flop_fraction']:.2f})")
            if self.quality_probes:
                spec += (f" | quality top1 {r['quality_top1_rate']:.2f} "
                         f"over {self.quality_probes} probes")
        if self.shed or self.tier_demotions or self.failovers:
            spec += (f" | shed {self.shed} "
                     f"(deadline {self.deadline_missed}, "
                     f"pool {self.shed_pool_pressure})"
                     f" | demotions {self.tier_demotions}"
                     f" | failovers {self.failovers}")
        return (f"{int(r['requests_completed'])} reqs, "
                f"{int(r['tokens_generated'])} toks in {r['wall_seconds']:.2f}s"
                f" | {r['tok_per_s']:.1f} tok/s wall, "
                f"{r['tokens_per_step']:.2f} tok/step"
                f" | {r['host_syncs_per_token']:.2f} syncs/tok"
                f" | occupancy {r['mean_occupancy']:.2f}"
                f" | latency p50/p99 {r['latency_steps_p50']:.0f}/"
                f"{r['latency_steps_p99']:.0f} steps"
                f" | ttft p50 {r['ttft_steps_p50']:.0f} steps" + spec)

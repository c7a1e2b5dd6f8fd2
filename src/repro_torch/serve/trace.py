"""Serve tracing: ring-buffer lifecycle events, span timelines, exports
(port of `repro.serve.trace`).

Every request that moves through the serving stack crosses a fixed set of
lifecycle edges — submit, admit (with its prefix-match outcome), prefill,
first token, finish — and every engine step crosses dispatch edges (decode
/ speculative propose-then-verify, host syncs, page-pool traffic). The
tracer records each edge as ONE ring-buffer event carrying both clocks the
metrics layer reports in:

  * `step` — the deterministic engine-step clock;
  * `t`    — monotonic wall seconds since the tracer's epoch
    (`time.perf_counter`); the epoch's wall-clock anchor (`epoch_wall`) is
    kept so exports can be correlated with external logs.

Zero cost when disabled: the engine holds `NULL_TRACER` (module singleton)
unless `EngineConfig.trace` is set, and every hot-path hook is a plain
attribute lookup + a fixed-arity no-op method call: no conditionals, no
*args tuple packing, no keyword dicts, nothing allocated
(`tests/test_torch_trace.py` holds this). Call sites pass only values they
already hold (the per-dispatch sync byte counts are engine-lifetime
constants), so the disabled path does no extra work.

Span pairing: `request_spans()` folds the ring buffer into one timeline per
request — queue (submit -> admit), TTFT (submit -> first token), decode
(first token -> finish) — in both clocks. The step-clock numbers reconcile
exactly with `ServeMetrics.report()`.

Exports: JSONL (`export_jsonl`, one meta line then one event per line; the
schema of docs/trace_format.md) and Chrome trace-event JSON
(`export_chrome`, for chrome://tracing or ui.perfetto.dev: one process per
replica, one thread track per slot plus the admission and dispatch tracks,
request spans as complete events with their step-clock numbers in `args`,
and an occupancy counter track).

Profiler capture: `TraceConfig.profile_dir` brackets the first
`profile_dispatches` traced decode dispatches with `torch.profiler.profile`
(CPU and CUDA activity on the card, CPU activity on the CPU) and writes
its Chrome trace into `profile_dir` (`Tracer.profile_path`), so the device
timeline of the graph replays lands next to the host spans. kineto admits
one profiler session a process: a bracket that would open while another
profiler runs (a second replica's bracket, or any outside session) is
skipped, as the JAX package's bracket skips an unavailable profiler; any
other profiler failure propagates.

The ring buffer (`capacity` events, default 64k) makes tracing safe to
leave on: old events fall off the head (counted in `dropped`); span pairing
omits requests whose submit edge was evicted.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracing knobs, carried by `EngineConfig.trace` (None = tracing off).

    out / chrome: default export paths used by `Tracer.export()`.
    profile_dir: bracket the first `profile_dispatches` decode dispatches
    with torch.profiler and write its Chrome trace there."""

    capacity: int = 1 << 16            # ring-buffer events retained
    out: Optional[str] = None          # JSONL export path (export())
    chrome: Optional[str] = None       # chrome://tracing JSON path
    profile_dir: Optional[str] = None  # torch.profiler trace directory
    profile_dispatches: int = 3        # dispatches inside the bracket


class NullTracer:
    """The disabled tracer: every hook is a fixed-arity no-op.

    The engine's hot path calls these unconditionally; positional,
    fixed-arity signatures mean CPython allocates nothing per call. `step`,
    `replica` and `process` exist so call sites and the routers can assign
    them without isinstance checks."""

    enabled = False

    def __init__(self) -> None:
        self.step = 0
        self.replica = 0
        self.process = None  # fleet process index; None = not in a fleet,
        #                      and the exports stay byte-identical
        self.dropped = 0     # ring-buffer losses: always 0 when disabled

    # -- lifecycle edges ----------------------------------------------------

    def submit(self, rid, n_prompt, arrival_step):
        pass

    def reject(self, n_waiting):
        pass

    def admit(self, rid, slot, matched, n_prompt):
        pass

    def prefill(self, rid, slot, n_tokens, n_padded, suffix):
        pass

    def first_token(self, rid, slot, step):
        pass

    def finish(self, rid, slot, step, n_generated):
        pass

    # -- dispatch edges -----------------------------------------------------

    def dispatch_begin(self):
        pass

    def decode_dispatch(self, k, n_active, n_slots):
        pass

    def spec_dispatch(self, k, n_active, n_slots):
        pass

    def spec_slot(self, slot, accepted, committed, proposed):
        pass

    def host_sync(self, kind, n_bytes):
        pass

    # -- ineffectual-work ledger edges (serve.ledger) -----------------------

    def ledger_dispatch(self, step, zero_frac, near_frac, dead_frac,
                        eff_flop_frac, flops_dense, flops_eff):
        pass

    def quality_probe(self, rid, tier, top1, mad):
        pass

    # -- page-pool edges ----------------------------------------------------

    def page_alloc(self, slot, n_shared, n_fresh):
        pass

    def page_free(self, slot, n_pages):
        pass

    def page_evict(self, n_pages):
        pass

    def pool_wait(self):
        pass

    def gather_avoided(self, n_bytes):
        pass

    def conversation_hit(self, rid, matched):
        pass

    # -- resilience edges (serve.qos / chaos / failover) --------------------

    def tier_change(self, old_tier, new_tier, load):
        pass

    def req_tier(self, rid, tier):
        pass

    def shed(self, rid, slot, reason, n_generated):
        pass

    def failover(self, rid, src_replica):
        pass

    def fault(self, kind, detail):
        pass

    # -- introspection (empty on the null tracer) ---------------------------

    def request_spans(self) -> Dict[int, Dict[str, Any]]:
        return {}

    def export(self) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Ring-buffer event recorder with span pairing and exports. `device`
    ("cuda" or "cpu", the engine's) picks the profiler's activities."""

    enabled = True

    def __init__(self, cfg: Optional[TraceConfig] = None, *,
                 replica: int = 0, device: str = "cpu") -> None:
        super().__init__()
        self.cfg = cfg or TraceConfig()
        self.replica = replica
        self.device = device
        self.epoch = time.perf_counter()   # monotonic zero for every event
        self.epoch_wall = time.time()      # wall anchor for correlation
        self.events: collections.deque = collections.deque(
            maxlen=self.cfg.capacity)
        self.dropped = 0                   # events evicted by the ring
        self._t0d = 0.0                    # dispatch_begin timestamp
        self._profiling = False
        self._profile_left = (self.cfg.profile_dispatches
                              if self.cfg.profile_dir else 0)
        self._prof = None
        self.profile_path: Optional[str] = None   # the written Chrome trace

    # -- recording ----------------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def _t(self) -> float:
        return time.perf_counter() - self.epoch

    def submit(self, rid, n_prompt, arrival_step):
        self._push({"ev": "submit", "step": self.step, "t": self._t(),
                    "rid": rid, "n_prompt": n_prompt,
                    "arrival_step": arrival_step})

    def reject(self, n_waiting):
        self._push({"ev": "reject", "step": self.step, "t": self._t(),
                    "n_waiting": n_waiting})

    def admit(self, rid, slot, matched, n_prompt):
        self._push({"ev": "admit", "step": self.step, "t": self._t(),
                    "rid": rid, "slot": slot, "prefix_matched": matched,
                    "prefix_skipped": matched, "n_prompt": n_prompt})

    def prefill(self, rid, slot, n_tokens, n_padded, suffix):
        self._push({"ev": "prefill", "step": self.step, "t": self._t(),
                    "rid": rid, "slot": slot, "n_tokens": n_tokens,
                    "n_padded": n_padded, "suffix": bool(suffix)})

    def first_token(self, rid, slot, step):
        self._push({"ev": "first_token", "step": step, "t": self._t(),
                    "rid": rid, "slot": slot})

    def finish(self, rid, slot, step, n_generated):
        self._push({"ev": "finish", "step": step, "t": self._t(),
                    "rid": rid, "slot": slot, "n_generated": n_generated})

    def dispatch_begin(self):
        self._t0d = self._t()
        if self._profile_left and not self._profiling:
            self._profiling = self._profiler_start()

    def decode_dispatch(self, k, n_active, n_slots):
        t = self._t()
        self._push({"ev": "decode", "step": self.step, "t": self._t0d,
                    "dur": t - self._t0d, "k": k, "n_active": n_active,
                    "occupancy": n_active / max(1, n_slots)})
        self._profiler_tick()

    def spec_dispatch(self, k, n_active, n_slots):
        t = self._t()
        self._push({"ev": "spec", "step": self.step, "t": self._t0d,
                    "dur": t - self._t0d, "k": k, "n_active": n_active,
                    "occupancy": n_active / max(1, n_slots)})
        self._profiler_tick()

    def spec_slot(self, slot, accepted, committed, proposed):
        self._push({"ev": "spec_slot", "step": self.step, "t": self._t(),
                    "slot": slot, "accepted": accepted,
                    "committed": committed, "proposed": proposed,
                    "rolled_back": proposed - accepted})

    def host_sync(self, kind, n_bytes):
        self._push({"ev": "host_sync", "step": self.step, "t": self._t(),
                    "kind": kind, "bytes": n_bytes})

    def ledger_dispatch(self, step, zero_frac, near_frac, dead_frac,
                        eff_flop_frac, flops_dense, flops_eff):
        """Per-dispatch drained ledger fractions (serve.ledger): rendered
        as Chrome counter tracks alongside occupancy."""
        self._push({"ev": "ledger", "step": step, "t": self._t(),
                    "zero_frac": float(zero_frac),
                    "near_frac": float(near_frac),
                    "dead_frac": float(dead_frac),
                    "eff_flop_frac": float(eff_flop_frac),
                    "flops_dense": float(flops_dense),
                    "flops_eff": float(flops_eff)})

    def quality_probe(self, rid, tier, top1, mad):
        self._push({"ev": "quality_probe", "step": self.step,
                    "t": self._t(), "rid": rid, "tier": tier,
                    "top1": bool(top1), "mad": float(mad)})

    def page_alloc(self, slot, n_shared, n_fresh):
        self._push({"ev": "page_alloc", "step": self.step, "t": self._t(),
                    "slot": slot, "shared": n_shared, "fresh": n_fresh})

    def page_free(self, slot, n_pages):
        self._push({"ev": "page_free", "step": self.step, "t": self._t(),
                    "slot": slot, "n_pages": n_pages})

    def page_evict(self, n_pages):
        self._push({"ev": "page_evict", "step": self.step, "t": self._t(),
                    "n_pages": n_pages})

    def pool_wait(self):
        self._push({"ev": "pool_wait", "step": self.step, "t": self._t()})

    def gather_avoided(self, n_bytes):
        self._push({"ev": "gather_avoided", "step": self.step,
                    "t": self._t(), "bytes": n_bytes})

    def conversation_hit(self, rid, matched):
        self._push({"ev": "conversation_hit", "step": self.step,
                    "t": self._t(), "rid": rid, "matched": matched})

    def tier_change(self, old_tier, new_tier, load):
        self._push({"ev": "tier_change", "step": self.step, "t": self._t(),
                    "old_tier": old_tier, "new_tier": new_tier,
                    "load": load})

    def req_tier(self, rid, tier):
        self._push({"ev": "req_tier", "step": self.step, "t": self._t(),
                    "rid": rid, "tier": tier})

    def shed(self, rid, slot, reason, n_generated):
        self._push({"ev": "shed", "step": self.step, "t": self._t(),
                    "rid": rid, "slot": slot, "reason": reason,
                    "n_generated": n_generated})

    def failover(self, rid, src_replica):
        self._push({"ev": "failover", "step": self.step, "t": self._t(),
                    "rid": rid, "src_replica": src_replica})

    def fault(self, kind, detail):
        self._push({"ev": "fault", "step": self.step, "t": self._t(),
                    "kind": kind, "detail": detail})

    # -- profiler bracket ---------------------------------------------------

    def _profiler_start(self) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if torch.autograd._profiler_enabled():
            # another session (another replica's bracket, or any other
            # profiler) holds kineto, which runs one at a time: skipped
            self._profile_left = 0
            return False
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._push({"ev": "profile_start", "step": self.step,
                    "t": self._t(), "dir": self.cfg.profile_dir,
                    "dispatches": self.cfg.profile_dispatches})
        return True

    def _profiler_tick(self) -> None:
        if not self._profiling:
            return
        self._profile_left -= 1
        if self._profile_left <= 0:
            self._prof.stop()
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            self.profile_path = os.path.join(
                self.cfg.profile_dir,
                f"replica{self.replica}-{os.getpid()}.trace.json")
            self._prof.export_chrome_trace(self.profile_path)
            self._prof = None
            self._profiling = False
            self._push({"ev": "profile_stop", "step": self.step,
                        "t": self._t()})

    # -- span pairing -------------------------------------------------------

    def request_spans(self) -> Dict[int, Dict[str, Any]]:
        """Per-request timeline folded from the ring buffer, both clocks.

        Step-clock fields reconcile exactly with ServeMetrics.report():
        `ttft_steps` = first_token_step - arrival_step, `latency_steps` =
        finish_step - arrival_step, `tokens` = the request's generated
        count. Requests whose submit edge fell off the ring are omitted."""
        spans: Dict[int, Dict[str, Any]] = {}
        for ev in self.events:
            rid = ev.get("rid")
            if rid is None:
                continue
            kind = ev["ev"]
            if kind == "submit":
                spans[rid] = {
                    "rid": rid, "replica": self.replica,
                    "arrival_step": ev["arrival_step"],
                    "n_prompt": ev["n_prompt"],
                    "submit_step": ev["step"], "submit_t": ev["t"],
                }
            s = spans.get(rid)
            if s is None:
                continue                    # submit edge evicted: skip
            if kind == "admit":
                s.update(admit_step=ev["step"], admit_t=ev["t"],
                         slot=ev["slot"],
                         prefix_matched=ev["prefix_matched"])
            elif kind == "prefill":
                s.update(prefill_tokens=ev["n_tokens"],
                         prefill_padded=ev["n_padded"],
                         suffix_prefill=ev["suffix"])
            elif kind == "first_token":
                s.update(first_token_step=ev["step"], first_token_t=ev["t"])
            elif kind == "finish":
                s.update(finish_step=ev["step"], finish_t=ev["t"],
                         tokens=ev["n_generated"])
            elif kind == "req_tier":
                # tier transitions in admission order: [admit tier, ...]
                s.setdefault("tiers", []).append(ev["tier"])
            elif kind == "shed":
                s.update(shed_step=ev["step"], shed_t=ev["t"],
                         shed_reason=ev["reason"],
                         tokens=ev["n_generated"])
            elif kind == "failover":
                s.update(failover_step=ev["step"],
                         failover_from=ev["src_replica"])
        for s in spans.values():
            if "admit_step" in s:
                s["queue_steps"] = s["admit_step"] - s["arrival_step"]
                s["queue_s"] = s["admit_t"] - s["submit_t"]
            if "first_token_step" in s:
                s["ttft_steps"] = s["first_token_step"] - s["arrival_step"]
                s["ttft_s"] = s["first_token_t"] - s["submit_t"]
            if "finish_step" in s:
                s["latency_steps"] = s["finish_step"] - s["arrival_step"]
                s["latency_s"] = s["finish_t"] - s["submit_t"]
                if "first_token_step" in s:
                    s["decode_steps"] = s["finish_step"] \
                        - s["first_token_step"]
        return spans

    def format_timeline(self, rid: int) -> str:
        """Human-readable one-request timeline."""
        s = self.request_spans().get(rid)
        if s is None:
            return f"req{rid}: no events retained"
        lines = [f"req{rid} (replica {s['replica']}, "
                 f"slot {s.get('slot', '?')}, "
                 f"prompt {s['n_prompt']} toks, "
                 f"prefix matched {s.get('prefix_matched', 0)}):"]
        for label, step_k, wall_k in (
                ("queue  (submit -> admit)", "queue_steps", "queue_s"),
                ("ttft   (submit -> tok 0)", "ttft_steps", "ttft_s"),
                ("decode (tok 0 -> finish)", "decode_steps", None),
                ("total  (submit -> finish)", "latency_steps", "latency_s")):
            if step_k not in s:
                continue
            wall = f", {s[wall_k] * 1e3:8.2f} ms" if wall_k else ""
            lines.append(f"  {label}: {s[step_k]:4d} steps{wall}")
        if "tokens" in s:
            lines.append(f"  generated {s['tokens']} tokens")
        return "\n".join(lines)

    # -- exports ------------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        return export_jsonl([self], path)

    def export_chrome(self, path: str) -> int:
        return export_chrome([self], path)

    def export(self) -> None:
        """Write the configured default exports (TraceConfig.out/chrome)."""
        if self.cfg.out:
            self.export_jsonl(self.cfg.out)
        if self.cfg.chrome:
            self.export_chrome(self.cfg.chrome)


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def export_jsonl(tracers: Sequence[Tracer], path: str) -> int:
    """All tracers' ring buffers as JSONL: one meta line per tracer, then
    its events, each stamped with the replica id (and, in a fleet, the
    process index). Returns events written."""
    _ensure_dir(path)
    n = 0
    with open(path, "w") as f:
        for tr in tracers:
            # a fleet stamps the process index into the meta line and every
            # event; outside one there is no key at all, so the output is
            # byte-identical to a tracer without the attribute
            ptag = {} if tr.process is None else {"process": tr.process}
            f.write(json.dumps({
                "ev": "meta", **ptag, "replica": tr.replica,
                "epoch_wall": tr.epoch_wall, "dropped": tr.dropped,
                "capacity": tr.cfg.capacity,
                "clocks": {"step": "engine steps",
                           "t": "monotonic seconds since epoch_wall"},
            }) + "\n")
            for ev in tr.events:
                f.write(json.dumps({**ptag, "replica": tr.replica, **ev})
                        + "\n")
                n += 1
    return n


_ADMIT_TID = 0          # queue spans (no slot yet)
_DISPATCH_TID = 9999    # decode/spec dispatch spans


def chrome_events(tr: Tracer) -> List[Dict[str, Any]]:
    """One tracer's events in Chrome trace-event form: pid = replica,
    tid = slot + 1 for request spans (one track per slot), the admission
    queue on tid 0, dispatches on their own track, occupancy as a counter
    series. ts/dur in microseconds on the monotonic clock. In a fleet each
    process gets a disjoint pid block (process x 4096 + replica), so two
    processes' replica 0 tracks never merge."""
    if tr.process is None:
        pid, pname = tr.replica, f"replica {tr.replica}"
    else:
        pid = tr.process * 4096 + tr.replica
        pname = f"process {tr.process} replica {tr.replica}"
    evs: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": pname}},
        {"ph": "M", "pid": pid, "tid": _ADMIT_TID, "name": "thread_name",
         "args": {"name": "admission queue"}},
        {"ph": "M", "pid": pid, "tid": _DISPATCH_TID, "name": "thread_name",
         "args": {"name": "dispatch"}},
    ]
    named_slots = set()

    def us(t: float) -> float:
        return t * 1e6

    for ev in tr.events:
        if ev["ev"] in ("decode", "spec"):
            evs.append({"ph": "X", "pid": pid, "tid": _DISPATCH_TID,
                        "name": ev["ev"], "cat": "dispatch",
                        "ts": us(ev["t"]), "dur": us(ev["dur"]),
                        "args": {"step": ev["step"], "k": ev["k"],
                                 "n_active": ev["n_active"]}})
            evs.append({"ph": "C", "pid": pid, "name": "occupancy",
                        "ts": us(ev["t"]),
                        "args": {"active": ev["n_active"]}})
        elif ev["ev"] == "host_sync":
            evs.append({"ph": "i", "pid": pid, "tid": _DISPATCH_TID,
                        "name": f"sync:{ev['kind']}", "cat": "sync",
                        "s": "t", "ts": us(ev["t"]),
                        "args": {"bytes": ev["bytes"], "step": ev["step"]}})
        elif ev["ev"] == "ledger":
            # counter tracks: activation ineffectuality and the effective
            # FLOP fraction per dispatch, next to the occupancy series
            evs.append({"ph": "C", "pid": pid, "name": "act_sparsity",
                        "ts": us(ev["t"]),
                        "args": {"zero_frac": ev["zero_frac"],
                                 "dead_kblock_frac": ev["dead_frac"]}})
            evs.append({"ph": "C", "pid": pid, "name": "effective_flops",
                        "ts": us(ev["t"]),
                        "args": {"eff_frac": ev["eff_flop_frac"]}})
        elif ev["ev"] == "quality_probe":
            evs.append({"ph": "i", "pid": pid, "tid": _DISPATCH_TID,
                        "name": f"quality:tier{ev['tier']}", "cat": "quality",
                        "s": "t", "ts": us(ev["t"]),
                        "args": {"rid": ev["rid"], "top1": ev["top1"],
                                 "mad": ev["mad"], "step": ev["step"]}})
    for s in tr.request_spans().values():
        if "admit_t" in s:
            evs.append({"ph": "X", "pid": pid, "tid": _ADMIT_TID,
                        "name": f"req{s['rid']} queued", "cat": "queue",
                        "ts": us(s["submit_t"]),
                        "dur": us(max(0.0, s["queue_s"])),
                        "args": {"queue_steps": s["queue_steps"],
                                 "arrival_step": s["arrival_step"]}})
        if "admit_t" in s and "finish_t" in s:
            tid = s["slot"] + 1
            if tid not in named_slots:
                named_slots.add(tid)
                evs.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": f"slot {s['slot']}"}})
            evs.append({"ph": "X", "pid": pid, "tid": tid,
                        "name": f"req{s['rid']}", "cat": "request",
                        "ts": us(s["admit_t"]),
                        "dur": us(max(0.0, s["finish_t"] - s["admit_t"])),
                        "args": {k: s[k] for k in
                                 ("ttft_steps", "latency_steps", "tokens",
                                  "n_prompt", "prefix_matched",
                                  "arrival_step") if k in s}})
    return evs


def export_chrome(tracers: Sequence[Tracer], path: str) -> int:
    """Merged chrome://tracing JSON over any number of replica tracers
    (one process per replica). Returns the number of trace events."""
    _ensure_dir(path)
    evs: List[Dict[str, Any]] = []
    for tr in tracers:
        evs.extend(chrome_events(tr))
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)

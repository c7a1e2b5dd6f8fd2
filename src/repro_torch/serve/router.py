"""Replica router: one front-end over N engine replicas, and the fleet
router one process boundary up (the `ReplicaRouter`, `FleetRequest` and
`FleetRouter` of `repro.serve.router`).

A replica is a whole `InferenceEngine`: its own KV slab or page pool, its
loop state and, on the card, its own CUDA graphs. `build` makes N replicas
of one `PackedModel`, so they share its device weights. The router owns
nothing that executes: it decides which replica a request joins, steps the
replicas in lockstep rounds, and aggregates their metrics.

Admission (least-loaded): `submit` scores every replica with
`scheduler.replica_load` (active + waiting - free) and tries them in
ascending-load order, with a rotating tiebreak so equal-load replicas
share arrivals round-robin. A replica whose bounded waiting deque
(`EngineConfig.max_waiting`) is full raises `EngineSaturated`; the router
counts the spill and tries the next. When every replica rejects, the
request parks in the router's overflow deque and drains into the first
replica with queue headroom at the next `step()`.

Rebalance: each `step()`, a replica whose waiting deque exceeds its free
slots donates tail-of-queue requests (`engine.steal_waiting`, never-started
requests only) to replicas with immediate headroom (`engine.adopt`).

The router's clock: one `step()` = one engine step per live replica (an
idle replica ticks without a dispatch). `report()` adds
`tokens_per_router_step`.

Failover: a replica whose step raises `ReplicaFault` (a crashed dispatch,
or the engine's sync validation caught corrupt output) is marked dead and
its unfinished requests are evacuated (`engine.evacuate`: running requests
fold their output into their prompts, so a survivor's greedy re-prefill
resumes each stream token for token) and re-admitted with `failover_from`
stamped (the adopting engine counts `failovers`). With `auto_restart` the
dead replica is replaced by `engine_factory(i)`; the dead engine is
dropped before the fresh one is built, so its cache and graph pool are
freed first, and its metrics retire into the fleet aggregate. `run()`
raises rather than spins when work remains and no replica is alive.

Fleet: `FleetRouter` lifts the same semantics across PROCESSES, each
running its own ReplicaRouter (serve.control's `LocalProcess` in this
process, `RemoteProcess` over a socket to a `launch.fleet` worker):
least-loaded admission off possibly-stale heartbeat snapshots plus
in-flight submit credits, parked overflow, and heartbeat-timeout failover
that re-prefills a dead process's unfinished requests (prompt plus every
token already reported) on a survivor.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.control import FleetConfig, FleetState, ProcessStatus
from repro_torch.serve.engine import (EngineConfig, EngineSaturated,
                                      InferenceEngine, ReplicaFault)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Request, replica_load


class ReplicaRouter:
    """Least-loaded request routing + drain/rebalance over engine replicas."""

    def __init__(self, replicas: Sequence[InferenceEngine], *,
                 hold_overflow: bool = True, engine_factory=None,
                 auto_restart: bool = False):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if auto_restart and engine_factory is None:
            raise ValueError("auto_restart needs an engine_factory(i) to "
                             "build the replacement replica")
        self.replicas = list(replicas)
        for i, eng in enumerate(self.replicas):
            eng.trace.replica = i      # stamps events + Chrome process ids
        self.hold_overflow = hold_overflow
        self.engine_factory = engine_factory
        self.auto_restart = auto_restart
        self.alive: List[bool] = [True] * len(self.replicas)
        self._overflow: collections.deque = collections.deque()
        self._rr = 0                      # rotating tiebreak for equal loads
        self.step_count = 0
        self.spills = 0                   # submits bounced to a sibling
        self.overflowed = 0               # submits parked in the router deque
        self.rebalanced = 0               # waiting requests moved mid-run
        self.rejected_fleet = 0           # submits EVERY replica rejected
        self.replica_deaths = 0           # ReplicaFault -> marked dead
        self.restarts = 0                 # dead replicas replaced fresh
        # metrics of replaced replicas: a restart must never lose counters
        # from the fleet aggregate
        self._retired_metrics: List[ServeMetrics] = []
        self.requests: List[Request] = []

    @classmethod
    def build(cls, model, cfg: EngineConfig, n_replicas: int, *,
              backend_factory=None, scheduler_factory=None,
              **kwargs) -> "ReplicaRouter":
        """N identical replicas of (model, cfg), sharing the model's device
        weights; each builds its own cache, backend and CUDA graphs.
        backend_factory(i) returns the i-th replica's ExecutionBackend
        (None = a LocalBackend each); scheduler_factory(i) likewise its
        admission policy. The same closure becomes the router's
        `engine_factory`, so `auto_restart` rebuilds a replica with its
        factories' backend and scheduler."""
        def engine_factory(i: int) -> InferenceEngine:
            return InferenceEngine(
                model, cfg,
                scheduler=scheduler_factory(i) if scheduler_factory else None,
                backend=backend_factory(i) if backend_factory else None)

        replicas = [engine_factory(i) for i in range(n_replicas)]
        kwargs.setdefault("engine_factory", engine_factory)
        return cls(replicas, **kwargs)

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new_tokens: int, **kw) -> Request:
        r = Request(id=-1, prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens,
                    arrival_step=kw.pop("arrival_step", 0),
                    temperature=kw.pop("temperature", 0.0),
                    eos_id=kw.pop("eos_id", None),
                    extras=kw.pop("extras", None),
                    on_token=kw.pop("on_token", None),
                    speculate=kw.pop("speculate", None),
                    deadline_steps=kw.pop("deadline_steps", None),
                    deadline_ms=kw.pop("deadline_ms", None),
                    slo=kw.pop("slo", ""))
        if kw:
            raise TypeError(f"unknown submit kwargs: {sorted(kw)}")
        self.requests.append(r)
        placed = self._place(r)
        if placed:
            return r
        if not self.hold_overflow:
            self.requests.pop()
            # counted ONCE at the router: the per-replica `rejected`
            # counters record every bounce (one submit can bounce off all
            # N), so the fleet-level refusal needs its own counter for
            # per-replica/fleet totals to reconcile
            self.rejected_fleet += 1
            raise EngineSaturated("all replicas rejected the request")
        self._overflow.append(r)
        self.overflowed += 1
        return r

    @property
    def n_waiting(self) -> int:
        return len(self._overflow) + sum(e.n_waiting for e in self.replicas)

    @property
    def n_active(self) -> int:
        return sum(e.pool.n_active for e in self.replicas)

    def step(self) -> None:
        """One lockstep round: drain overflow, rebalance skewed queues,
        then one engine step per replica. Idle replicas step too (a free
        idle tick, no dispatch): freezing an idle replica's local clock
        would make a request adopted later — whose arrival_step is on the
        trace-global clock — wait out the frozen gap all over again, and
        would skew its latency record against replicas that kept ticking."""
        self.step_count += 1
        self._drain_overflow()
        self._rebalance()
        for i in range(len(self.replicas)):
            if not self.alive[i]:
                continue
            try:
                self.replicas[i].step()
            except ReplicaFault as e:
                self._fail(i, e)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        limit = max_steps if max_steps is not None else \
            10 * sum(r.max_new_tokens + 2 for r in self.requests) \
            + max([r.arrival_step for r in self.requests], default=0)
        while self.n_waiting or self.n_active:
            if not any(self.alive):
                raise RuntimeError(
                    "every replica is dead with work remaining — enable "
                    "auto_restart or drain the overflow elsewhere")
            if limit <= 0:
                raise RuntimeError("router did not drain within step limit")
            self.step()
            limit -= 1
        return {i: list(r.generated) for i, r in enumerate(self.requests)}

    def report(self) -> Dict[str, Any]:
        pool = self._retired_metrics + [e.metrics for e in self.replicas]
        rep = ServeMetrics.aggregate(pool)
        # retired metrics joined the pool above; the fleet SIZE is the
        # replica count, not the metrics count
        rep["n_replicas"] = float(len(self.replicas))
        rep.update({
            "router_steps": float(self.step_count),
            "tokens_per_router_step": rep["tokens_generated"]
            / max(1, self.step_count),
            "spills": float(self.spills),
            "overflowed": float(self.overflowed),
            "rebalanced": float(self.rebalanced),
            "rejected_fleet": float(self.rejected_fleet),
            "replica_deaths": float(self.replica_deaths),
            "restarts": float(self.restarts),
        })
        return rep

    @property
    def tracers(self) -> List[Any]:
        """Replica tracers with events (empty when tracing is off) — feed
        straight into trace.export_jsonl / trace.export_chrome for one
        merged fleet trace, one Chrome process per replica."""
        return [e.trace for e in self.replicas if e.trace.enabled]

    def format_report(self) -> str:
        r = self.report()
        return (f"{int(r['n_replicas'])} replicas | "
                f"{int(r['requests_completed'])} reqs, "
                f"{int(r['tokens_generated'])} toks"
                f" | {r['tokens_per_router_step']:.2f} tok/router-step, "
                f"{r['tok_per_s']:.1f} tok/s wall"
                f" | occupancy {r['mean_occupancy']:.2f}"
                f" | spills {int(r['spills'])}, "
                f"rebalanced {int(r['rebalanced'])}, "
                f"rejected {int(r['rejected'])}"
                + (f" | deaths {int(r['replica_deaths'])}, "
                   f"restarts {int(r['restarts'])}, "
                   f"failovers {int(r['failovers'])}"
                   if r["replica_deaths"] else ""))

    # ------------------------------------------------------------- internals

    def _order(self) -> List[int]:
        n = len(self.replicas)
        loads = [replica_load(e.pool.n_active, e.pool.n_free, e.n_waiting)
                 for e in self.replicas]
        order = sorted(range(n), key=lambda i: (loads[i], (i - self._rr) % n))
        self._rr = (self._rr + 1) % n
        return [i for i in order if self.alive[i]]

    def _fail(self, i: int, err: Exception) -> None:
        """Health-check verdict: mark replica `i` dead, evacuate its
        non-finished requests, optionally restart it, then re-admit every
        orphan to a survivor (failover_from stamped — the adopting engine
        counts the failover). Orphans nobody can take park in overflow, or
        — with hold_overflow off — shed terminally on the dead replica's
        metrics so no request ever silently vanishes."""
        eng = self.replicas[i]
        self.alive[i] = False
        self.replica_deaths += 1
        eng.trace.fault("replica_dead", str(err))
        err.__traceback__ = None     # its frames would keep the engine alive
        orphans = eng.evacuate()
        metrics, trace = eng.metrics, eng.trace
        if self.auto_restart:
            self._retired_metrics.append(metrics)
            # drop the dead engine before the fresh one is built: its cache
            # and CUDA graphs are freed first (the build collects garbage
            # before it captures)
            self.replicas[i] = eng = None
            fresh = self.engine_factory(i)
            fresh.trace.replica = i
            self.replicas[i] = fresh
            self.alive[i] = True
            self.restarts += 1
        for r in orphans:
            r.failover_from = i
            if self._place(r):
                continue
            if self.hold_overflow:
                self._overflow.append(r)
                self.overflowed += 1
            else:
                r.state, r.shed_reason = "shed", "failover"
                metrics.on_shed("failover")
                trace.shed(r.id, -1, "failover", len(r.generated))

    def _place(self, r: Request) -> bool:
        for i in self._order():
            try:
                self.replicas[i].adopt(r)
                return True
            except EngineSaturated:
                self.spills += 1
        return False

    def _drain_overflow(self) -> None:
        """Move parked requests into replicas WITH QUEUE HEADROOM. Unlike
        the fresh-submit path this never knocks on a full deque: a retry
        round against a still-saturated fleet must not re-increment spills
        or the engines' rejected counters (those count submits that
        bounced, not rounds the fleet stayed busy)."""
        while self._overflow:
            placed = False
            for i in self._order():
                eng = self.replicas[i]
                if eng.cfg.max_waiting is not None \
                        and eng.n_waiting >= eng.cfg.max_waiting:
                    continue
                eng.adopt(self._overflow[0])   # headroom => cannot saturate
                placed = True
                break
            if not placed:
                return                   # still saturated; retry next round
            self._overflow.popleft()

    def _rebalance(self) -> None:
        """Move tail-of-queue waiting requests from replicas that cannot
        admit them soon (waiting > free slots) to replicas that can."""
        live = [e for i, e in enumerate(self.replicas) if self.alive[i]]
        for src in live:
            excess = src.n_waiting - src.pool.n_free
            if excess <= 0:
                continue
            for dst in sorted(live,
                              key=lambda e: replica_load(
                                  e.pool.n_active, e.pool.n_free,
                                  e.n_waiting)):
                if dst is src or excess <= 0:
                    continue
                room = dst.pool.n_free - dst.n_waiting
                if dst.cfg.max_waiting is not None:
                    room = min(room, dst.cfg.max_waiting - dst.n_waiting)
                if room <= 0:
                    continue
                moved = src.steal_waiting(min(room, excess))
                for r in moved:
                    try:
                        dst.adopt(r)     # room > 0 => cannot saturate ...
                    except (EngineSaturated, ValueError):
                        src.adopt(r)     # ... but heterogeneous replica
                        continue         # configs may still refuse: return
                    excess -= 1          # the request instead of losing it
                    self.rebalanced += 1


# --------------------------------------------------------------------- fleet

@dataclasses.dataclass
class FleetRequest:
    """The coordinator's handle on one fleet request. Unlike scheduler.
    Request it holds no engine state (the owning PROCESS has that), only
    what the coordinator needs to route, account, and fail over: the
    original prompt, the budget, and every token the fleet has reported
    so far (progress deltas + done messages, in order). On failover the
    accumulated tokens fold into the resubmitted prompt exactly like
    `engine.evacuate` folds generated output: the same re-prefill
    semantics, one process boundary up."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_step: int = 0
    temperature: float = 0.0
    eos_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    process: int = -1                 # owning process (-1 = unplaced)
    state: str = "waiting"            # waiting | running | done | shed
    failover_from: int = -1           # last dead process this escaped

    @property
    def generated(self) -> List[int]:
        return list(self.tokens)

    @property
    def finished(self) -> bool:
        return self.state in ("done", "shed")


class FleetRouter:
    """ReplicaRouter semantics lifted one process boundary up: least-
    loaded admission, spill-over and heartbeat-timeout failover across
    PROCESSES, each of which runs its own ReplicaRouter over its own
    engines. The two routers compose — fleet picks the process, the
    process's ReplicaRouter picks the replica.

    The crucial difference from ReplicaRouter: every signal here is a
    POSSIBLY-STALE message, not a live attribute. Admission reads
    `control.FleetState` (last heartbeat + in-flight submit credits, see
    its docstring for the anti-flap argument); liveness is heartbeat
    silence, not an exception (`ReplicaFault` cannot cross a process).
    Failover re-submits a dead process's unfinished requests to a
    survivor with the accumulated tokens folded into the prompt — greedy
    re-prefill continues the stream token-identically, the same
    guarantee `engine.evacuate` gives inside one process.

    `processes` are `control.ProcessHandle`s: LocalProcess (in-process,
    deterministic — tests and the coordinator's own engines) and
    RemoteProcess (a socket to a launch.fleet worker) mix freely.
    """

    def __init__(self, processes: Sequence[Any], *, cfg=None):
        if not processes:
            raise ValueError("fleet router needs at least one process")
        self.cfg = cfg or FleetConfig()
        self.state = FleetState(self.cfg)
        self.processes: Dict[int, Any] = {p.process_index: p
                                          for p in processes}
        if len(self.processes) != len(processes):
            raise ValueError("duplicate process_index in fleet")
        for pi in self.processes:
            # every handle was alive at construction (remote handles come
            # from a consumed hello handshake) — seed liveness so submits
            # before the first heartbeat spread on credits instead of
            # piling onto whichever process reports first
            self.state.last_seen.setdefault(pi, 0.0)
        self.now = 0.0                 # the coordinator's clock (steps here;
        #                                a live deployment may pass seconds)
        self.step_count = 0
        self.requests: Dict[int, FleetRequest] = {}
        self._next_rid = 0
        self._overflow: collections.deque = collections.deque()
        self.overflowed = 0
        self.fleet_failovers = 0       # unfinished requests re-homed
        self._reports: Dict[int, Dict[str, Any]] = {}
        self._said_bye: set = set()

    # ------------------------------------------------------------------ API

    def submit(self, prompt, max_new_tokens: int, **kw) -> FleetRequest:
        r = FleetRequest(
            rid=self._next_rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            arrival_step=kw.pop("arrival_step", 0),
            temperature=kw.pop("temperature", 0.0),
            eos_id=kw.pop("eos_id", None))
        if kw:
            raise TypeError(f"unknown submit kwargs: {sorted(kw)}")
        self._next_rid += 1
        self.requests[r.rid] = r
        if not self._dispatch(r):
            self._overflow.append(r.rid)   # no admissible process YET:
            self.overflowed += 1           # parks until snapshots arrive
        return r

    def step(self) -> None:
        """One coordinator round: advance/drain every process, fold their
        messages into FleetState, pass the death verdict on heartbeat
        silence (failing over the victims' requests), then drain parked
        submissions into whatever the fresh snapshots admit."""
        self.step_count += 1
        self.now = float(self.step_count)
        for pi, p in self.processes.items():
            # dead processes drain too: their late messages must be SEEN
            # to be counted ignored (resurrections_ignored), not left to
            # rot in a socket buffer
            for msg in p.pump(self.now):
                self._handle(pi, msg)
        for pi in self.state.check(self.now):
            self._failover(pi)
        self._drain_overflow()

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        limit = max_steps if max_steps is not None else \
            40 * sum(r.max_new_tokens + 2 for r in self.requests.values()) \
            + int(4 * self.cfg.heartbeat_timeout) + 100
        while any(not r.finished for r in self.requests.values()):
            live = [pi for pi in self.processes
                    if pi not in self.state.dead]
            if not live:
                raise RuntimeError("every fleet process is dead with work "
                                   "remaining")
            if limit <= 0:
                raise RuntimeError("fleet did not drain within step limit")
            self.step()
            limit -= 1
        return {r.rid: list(r.tokens) for r in self.requests.values()}

    def stop(self, max_steps: int = 2000) -> None:
        """Drain shutdown: ask every live process to stop, then pump until
        each has delivered its final report (or its socket dies)."""
        live = [pi for pi in self.processes if pi not in self.state.dead]
        for pi in live:
            self.processes[pi].stop()
        waiting = set(live)
        while waiting and max_steps > 0:
            max_steps -= 1
            progress = False
            for pi in list(waiting):
                p = self.processes[pi]
                for msg in p.pump(self.now):
                    self._handle(pi, msg)
                    progress = True
                if pi in self._reports or pi in self._said_bye \
                        or not p.alive:
                    waiting.discard(pi)
            if waiting and not progress:
                # subprocess workers need wall time to drain + report; a
                # tight loop would spin the step budget out in ms (in-
                # process fleets never hit this: their pump IS the work)
                time.sleep(0.002)

    def report(self) -> Dict[str, Any]:
        """Fleet-pooled metrics: every process ships its per-replica
        ServeMetrics payloads in its final report; the coordinator
        rebuilds the objects and reuses `ServeMetrics.aggregate` — the
        same pooling discipline (counters sum, percentiles pool the
        record union) as ReplicaRouter.report, now across processes.
        A crashed process's counters are lost with it (its report never
        arrives); the request-level truth (`fleet_tokens`) survives,
        because the coordinator accumulated every progress delta."""
        pool = [ServeMetrics.from_payload(pl)
                for rep in self._reports.values()
                for pl in rep.get("metrics", [])]
        agg = ServeMetrics.aggregate(pool) if pool else {}
        done = [r for r in self.requests.values() if r.state == "done"]
        # the fleet's deterministic clock: processes decode CONCURRENTLY,
        # so aggregate throughput per step is tokens over the SLOWEST
        # process's engine steps (a max, not a sum — the wall-clock analog
        # on the step clock), comparable to one engine's tokens_per_step
        fleet_steps = max((rep.get("fleet", {}).get("engine_steps", 0)
                           for rep in self._reports.values()), default=0)
        agg.update({
            "n_processes": float(len(self.processes)),
            "processes_dead": float(len(self.state.dead)),
            "fleet_steps": float(fleet_steps),
            "fleet_tokens": float(sum(len(r.tokens)
                                      for r in self.requests.values())),
            "fleet_requests_completed": float(len(done)),
            "tokens_per_fleet_step": sum(len(r.tokens) for r in done)
            / max(1, fleet_steps),
            "fleet_failovers": float(self.fleet_failovers),
            "fleet_overflowed": float(self.overflowed),
            "resurrections_ignored": float(self.state.resurrections_ignored),
            "stale_skips": float(self.state.stale_skips),
        })
        return agg

    # ------------------------------------------------------------- internals

    def _dispatch(self, r: FleetRequest) -> bool:
        """Least-loaded admissible process off the current snapshots. The
        wire prompt folds accumulated tokens in (empty on first dispatch,
        the failover re-prefill after a death); the wire budget shrinks by
        what was already generated — `engine.adopt`'s arithmetic."""
        pi = self.state.least_loaded(self.now)
        if pi is None:
            return False
        p = self.processes[pi]
        wire_prompt = np.concatenate(
            [r.prompt, np.asarray(r.tokens, np.int32)]) \
            if r.tokens else r.prompt
        ok = p.submit({"kind": "submit", "rid": r.rid, "prompt": wire_prompt,
                       "max_new_tokens": r.max_new_tokens - len(r.tokens),
                       "arrival_step": r.arrival_step,
                       "temperature": r.temperature, "eos_id": r.eos_id,
                       "failover_from": r.failover_from})
        if not ok:
            # the socket is already gone — a death verdict ahead of the
            # heartbeat timeout; fail over whatever else it held
            self.state.mark_dead(pi)
            self._failover(pi)
            return False
        self.state.note_submit(pi)
        r.process, r.state = pi, "running"
        return True

    def _handle(self, pi: int, msg: Dict[str, Any]) -> None:
        kind = msg.get("kind")
        if kind == "status":
            st = ProcessStatus.from_wire(msg)
            if st.process_index != pi:
                return                 # a socket must speak for itself
            if not self.state.observe(st, self.now):
                return                 # dead (resurrection) or stale seq:
            #                            progress dropped WITH the status —
            #                            a zombie's tokens are not truth
            for rid_s, toks in st.progress.items():
                r = self.requests.get(int(rid_s))
                if r is not None and r.process == pi and not r.finished:
                    r.tokens.extend(int(t) for t in toks)
        elif kind == "done":
            if pi in self.state.dead:
                self.state.resurrections_ignored += 1
                return
            r = self.requests.get(int(msg.get("rid", -1)))
            if r is None or r.process != pi or r.finished:
                return                 # failed over elsewhere meanwhile
            r.tokens.extend(int(t) for t in msg.get("tokens", []))
            r.state = msg.get("state", "done")
        elif kind == "hello":
            # liveness accounting starts at contact, not first status: a
            # worker that says hello and then wedges must still time out
            self.state.last_seen.setdefault(pi, self.now)
        elif kind == "report":
            if pi not in self.state.dead:
                self._reports[pi] = msg
        elif kind == "bye":
            self._said_bye.add(pi)
            self.state.last_seen.pop(pi, None)   # clean exit: silence is
            #                                      expected, not a death

    def _failover(self, pi: int) -> None:
        """Re-home every unfinished request of dead process `pi`. A
        request that already hit its budget (or generated its EOS) is
        complete — the coordinator HAS its tokens; only truly unfinished
        streams re-prefill on a survivor."""
        for r in self.requests.values():
            if r.process != pi or r.finished:
                continue
            r.failover_from = pi
            r.process = -1
            if r.max_new_tokens - len(r.tokens) <= 0 or (
                    r.eos_id is not None and r.tokens
                    and r.tokens[-1] == r.eos_id):
                r.state = "done"
                continue
            self.fleet_failovers += 1
            if not self._dispatch(r):
                self._overflow.append(r.rid)
                self.overflowed += 1

    def _drain_overflow(self) -> None:
        while self._overflow:
            r = self.requests[self._overflow[0]]
            if not r.finished and r.process < 0:
                if not self._dispatch(r):
                    return             # still nothing admissible: retry
                #                        next round, no flapping counters
            self._overflow.popleft()

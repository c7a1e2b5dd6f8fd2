"""Cross-process control plane for fleet serving (port of
`repro.serve.control`, a copy kept in the port: the same wire, the same
judgements, byte for byte the same messages).

A fleet is N serving processes, each running its own engines (on the card
every worker shares the one GPU); this module is the wire between them:
who is alive, how loaded they are, where a request should go, and what to
do when a process stops talking.

Design constraints, in order:

  * The DATA plane never crosses the wire. Decode stays each process's
    graphed device-resident dispatch (serve.backend); the control plane
    moves only small JSON messages: loads, heartbeats, prompts in, tokens
    out. A fleet of N processes is N independent engines plus this
    gossip, not one distributed program: no cross-process collectives,
    nothing to deadlock.
  * Every decision must work off a POSSIBLY-STALE snapshot. A load report
    is old the moment it is read; the router corrects for the messages it
    knows are in flight (`submits_sent - submits_seen`, the credit term in
    `FleetState.load`) and refuses placements on snapshots older than
    `staleness` rather than guessing.
  * Liveness is observed, never assumed: a process is dead when its
    heartbeats stop for `heartbeat_timeout`, and STAYS dead: a late
    "resurrection" message from a process already failed over would
    double-serve its requests, so `FleetState.observe` drops it.
  * Clock-agnostic: `now` is whatever float the caller advances (engine
    steps in deterministic tests, wall-paced coordinator steps in a live
    socket fleet). The logic never reads time itself.

Wire format: newline-delimited JSON, one message per line, each a dict
with a `"kind"` key. numpy and torch integer arrays (prompts, token
blocks) are encoded as plain lists by `encode_message`; `decode_message`
returns them as lists (the engine's submit path re-asserts int32 anyway).

Message kinds (the schema is documented in docs/multihost.md):

  hello   worker -> coordinator, once: {process_index, n_replicas}
  status  worker -> coordinator heartbeat: ProcessStatus.to_wire()
  submit  coordinator -> worker: {rid, prompt, max_new_tokens, ...}
  done    worker -> coordinator: {rid, process_index, tokens}
  report  worker -> coordinator, at stop: {process_index, metrics,
          fleet: {decode_steps, engine_steps}}
  stop    coordinator -> worker: drain and exit cleanly
  die     coordinator -> worker: exit WITHOUT goodbye (fault injection:
          the heartbeat-timeout path is the only way the fleet learns)
"""

from __future__ import annotations

import collections
import dataclasses
import json
import socket
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.scheduler import replica_load

WIRE_VERSION = 1


# ------------------------------------------------------------ serialization

def _jsonable(v: Any) -> Any:
    """Wire-safe view of a message value: numpy and torch arrays / scalars
    to plain python (a 0-d tensor to a scalar, as `Request.generated` may
    hold them), containers recursively. Rejects nothing: a field the
    schema does not know is carried verbatim (forward compatibility)."""
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def encode_message(msg: Dict[str, Any]) -> bytes:
    """One message -> one JSON line (newline-terminated). numpy and torch
    values (prompts, token lists, scalar counters) encode as plain JSON."""
    if "kind" not in msg:
        raise ValueError("control message needs a 'kind'")
    return (json.dumps(_jsonable(msg), separators=(",", ":"))
            + "\n").encode()


def decode_message(line: bytes) -> Dict[str, Any]:
    msg = json.loads(line.decode())
    if not isinstance(msg, dict) or "kind" not in msg:
        raise ValueError(f"not a control message: {line[:80]!r}")
    return msg


# ------------------------------------------------------------- status/state

@dataclasses.dataclass
class ProcessStatus:
    """One process's heartbeat: load + occupancy + liveness in a single
    message. `seq` increments per status so reordered/duplicated
    deliveries collapse; `submits_seen` echoes how many fleet submits
    the process has accounted for — the coordinator's in-flight credit
    term reads it (see FleetState.load)."""

    process_index: int
    seq: int
    step: int                        # the process's own engine-step clock
    replica_loads: List[int]         # scheduler.replica_load per replica
    n_free_slots: int
    n_waiting: int
    page_occupancy: float            # 0.0 on slab engines
    qos_tier: int
    submits_seen: int
    progress: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    # ^ fleet rid -> tokens generated SINCE the last status (deltas keep
    #   heartbeats small; the coordinator accumulates them so failover
    #   can fold everything a dead process already produced)

    def to_wire(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = "status"
        d["v"] = WIRE_VERSION
        return d

    @classmethod
    def from_wire(cls, msg: Dict[str, Any]) -> "ProcessStatus":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in msg.items() if k in fields})

    @property
    def load(self) -> int:
        return int(sum(self.replica_loads))


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Control-plane tuning. All horizons share ONE clock — whatever
    unit the caller's `now` advances in (coordinator steps in tests and
    in-process fleets, wall seconds if a deployment prefers). See
    docs/multihost.md for how the three relate; the invariants are
    heartbeat_every < staleness < heartbeat_timeout."""

    heartbeat_every: int = 2         # worker pumps between status sends
    staleness: float = 8.0           # max snapshot age admission tolerates
    heartbeat_timeout: float = 25.0  # silence after which a process is dead
    max_inflight: int = 0            # per-process admission cap (0 = off)

    def __post_init__(self):
        if not (0 < self.staleness <= self.heartbeat_timeout):
            raise ValueError(
                f"need 0 < staleness ({self.staleness}) <= heartbeat_timeout "
                f"({self.heartbeat_timeout}): a process must go stale "
                "(unpreferred) before it is declared dead (failover)")


class FleetState:
    """The coordinator's view of every process, built ONLY from observed
    messages. Owns the three fleet-health judgements:

      * effective load — last snapshot's load PLUS the submits this
        coordinator sent that the snapshot provably has not seen
        (`submits_sent - submits_seen`). The credit term is what stops
        stale-snapshot oscillation: without it, every arrival between
        two heartbeats lands on the same "least-loaded" process, then
        the next snapshot swings the herd to its sibling.
      * staleness — a process whose snapshot is older than
        `cfg.staleness` is not admitted to (returns None from
        `least_loaded` candidates) but is NOT dead yet.
      * death — silence past `cfg.heartbeat_timeout` (from `check`) or
        an explicit `mark_dead` (closed socket, waitpid). Death is
        terminal: later messages from that process index are counted in
        `resurrections_ignored` and dropped — its requests have been
        failed over; a zombie serving them again would double-emit.
    """

    def __init__(self, cfg: FleetConfig = FleetConfig()) -> None:
        self.cfg = cfg
        self.status: Dict[int, ProcessStatus] = {}
        self.last_seen: Dict[int, float] = {}
        self.submits_sent: Dict[int, int] = collections.defaultdict(int)
        self.dead: set = set()
        self.resurrections_ignored = 0
        self.stale_skips = 0          # placements refused on snapshot age
        self._rr = 0                  # rotating tiebreak, as in ReplicaRouter

    # -- observation --------------------------------------------------------

    def observe(self, st: ProcessStatus, now: float) -> bool:
        """Fold one heartbeat in. Returns False when ignored (process
        already dead, or a stale/duplicate seq)."""
        if st.process_index in self.dead:
            self.resurrections_ignored += 1
            return False
        prev = self.status.get(st.process_index)
        if prev is not None and st.seq <= prev.seq:
            return False              # reordered or duplicated delivery
        self.status[st.process_index] = st
        self.last_seen[st.process_index] = now
        return True

    def note_submit(self, process_index: int) -> None:
        self.submits_sent[process_index] += 1

    def mark_dead(self, process_index: int) -> None:
        self.dead.add(process_index)

    def check(self, now: float) -> List[int]:
        """Processes that JUST crossed heartbeat_timeout: marks them
        dead and returns them (the router fails their requests over)."""
        newly = [p for p, t in self.last_seen.items()
                 if p not in self.dead
                 and now - t > self.cfg.heartbeat_timeout]
        for p in newly:
            self.dead.add(p)
        return newly

    # -- judgements ---------------------------------------------------------

    def alive(self, process_index: int) -> bool:
        return (process_index in self.status
                and process_index not in self.dead)

    def staleness(self, process_index: int, now: float) -> float:
        return now - self.last_seen.get(process_index, -float("inf"))

    def load(self, process_index: int) -> int:
        """Effective load: snapshot load + in-flight submit credits. A
        process heard from (hello) but not yet snapshotted counts every
        submit sent as unseen load — admissible from step zero, so the
        first status to arrive doesn't soak up the whole backlog while
        its siblings are still booting."""
        st = self.status.get(process_index)
        if st is None:
            return self.submits_sent[process_index]
        credit = self.submits_sent[process_index] - st.submits_seen
        return st.load + max(0, credit)

    def inflight(self, process_index: int) -> int:
        st = self.status.get(process_index)
        seen = st.submits_seen if st is not None else 0
        return max(0, self.submits_sent[process_index] - seen)

    def least_loaded(self, now: float) -> Optional[int]:
        """The admission target, or None when no process qualifies
        (all dead, unheard-from, or past the staleness bound). Rotating
        tiebreak on equal effective loads, same discipline as
        ReplicaRouter._order."""
        cands = [p for p in self.last_seen
                 if p not in self.dead
                 and self.staleness(p, now) <= self.cfg.staleness
                 and (not self.cfg.max_inflight
                      or self.inflight(p) < self.cfg.max_inflight)]
        if not cands:
            if any(p not in self.dead for p in self.last_seen):
                self.stale_skips += 1
            return None
        n = max(cands) + 1
        cands.sort(key=lambda p: (self.load(p), (p - self._rr) % n))
        self._rr = (self._rr + 1) % max(1, n)
        return cands[0]

    def describe(self) -> Dict[str, Any]:
        return {
            "processes": sorted(self.status),
            "dead": sorted(self.dead),
            "loads": {p: self.load(p) for p in sorted(self.status)},
            "inflight": {p: self.inflight(p) for p in sorted(self.status)},
            "resurrections_ignored": self.resurrections_ignored,
            "stale_skips": self.stale_skips,
        }


# ---------------------------------------------------------------- transport

class Endpoint:
    """One duplex control connection: newline-framed JSON messages over a
    socket, a reader thread draining inbound lines into a queue so
    `poll()` never blocks the serving loop. Symmetric — both the
    coordinator and the worker hold one."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._inbox: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self.alive = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="control-endpoint")
        self._reader.start()

    def _read_loop(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self.sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line:
                        continue
                    msg = decode_message(line)
                    with self._lock:
                        self._inbox.append(msg)
        except OSError:
            pass
        self.alive = False

    def send(self, msg: Dict[str, Any]) -> bool:
        """Best-effort send; False when the peer is gone. A dead peer is
        a liveness fact for FleetState, never an exception on the
        serving path."""
        try:
            self.sock.sendall(encode_message(msg))
            return True
        except OSError:
            self.alive = False
            return False

    def poll(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._inbox)
            self._inbox.clear()
        return out

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class ControlListener:
    """Coordinator-side accept socket (127.0.0.1 by default — a real
    multi-host fleet binds its fabric address)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(16)
        self.address = "%s:%d" % self.sock.getsockname()[:2]

    def accept(self, timeout: float = 30.0) -> Endpoint:
        self.sock.settimeout(timeout)
        conn, _ = self.sock.accept()
        return Endpoint(conn)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect(address: str, timeout: float = 30.0) -> Endpoint:
    """Worker side: dial the coordinator's control address."""
    host, port = address.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    return Endpoint(sock)


# ------------------------------------------------------------ process faces

class ProcessHandle:
    """What the FleetRouter needs from one serving process. Two faces:
    `LocalProcess` (engines in THIS process: the coordinator serves
    too, and deterministic tests want no sockets) and `RemoteProcess`
    (an Endpoint to a worker). Both deliver the same message stream."""

    process_index: int = 0
    alive: bool = True

    def submit(self, msg: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def pump(self, now: float) -> List[Dict[str, Any]]:
        """Advance the process (local: one router step; remote: drain
        the socket) and return newly arrived control messages."""
        raise NotImplementedError

    def stop(self) -> None:
        pass

    def kill(self) -> None:
        """Fault injection: die without a goodbye message."""
        self.alive = False


class LocalProcess(ProcessHandle):
    """In-process worker: a ReplicaRouter (or single engine wrapped in
    one) stepped by `pump`, emitting the SAME status/done/report
    messages a socket worker would. `delay` buffers outbound messages
    for that many pumps — the deterministic stand-in for network lag
    the staleness tests replay."""

    def __init__(self, router, process_index: int = 0, *,
                 cfg: FleetConfig = FleetConfig(), delay: int = 0) -> None:
        self.router = router
        self.process_index = process_index
        self.cfg = cfg
        self.delay = delay
        self.alive = True
        self._stopped = False
        self._pumps = 0                # heartbeat clock: every pump, busy
        #                                or idle, so liveness outlives work
        self._seq = 0
        self._submits_seen = 0
        self._reported: Dict[int, int] = {}    # engine rid -> tokens sent
        self._rid_of: Dict[int, Any] = {}      # fleet rid -> Request
        self._done_sent: set = set()
        self._outbox: collections.deque = collections.deque()

    def submit(self, msg: Dict[str, Any]) -> bool:
        if not self.alive:
            return False
        r = self.router.submit(
            np.asarray(msg["prompt"], np.int32), int(msg["max_new_tokens"]),
            arrival_step=int(msg.get("arrival_step", 0)),
            temperature=float(msg.get("temperature", 0.0)),
            eos_id=msg.get("eos_id"))
        fo = msg.get("failover_from")
        if fo is not None and int(fo) >= 0:
            # cross-PROCESS failover: count on the adopting engine
            # (destination-side, like ReplicaRouter._fail). If the router
            # parked it instead, stamp the request so the eventual
            # engine.adopt does the counting (adopt resets the stamp).
            counted = False
            for e in self.router.replicas:
                if r.id >= 0 and r.id in e.requests:
                    e.metrics.on_failover()
                    counted = True
                    break
            if not counted:
                r.failover_from = int(fo)
        self._rid_of[int(msg["rid"])] = r
        self._submits_seen += 1
        return True

    def _status(self) -> ProcessStatus:
        self._seq += 1
        progress: Dict[str, List[int]] = {}
        for rid, r in self._rid_of.items():
            sent = self._reported.get(rid, 0)
            if len(r.generated) > sent:
                progress[str(rid)] = [int(t) for t in r.generated[sent:]]
                self._reported[rid] = len(r.generated)
        pages = [e.metrics.page_samples[-1] / e.metrics.page_capacity
                 for e in self.router.replicas
                 if e.metrics.page_samples and e.metrics.page_capacity]
        return ProcessStatus(
            process_index=self.process_index, seq=self._seq,
            step=self.router.step_count,
            replica_loads=[replica_load(e.pool.n_active, e.pool.n_free,
                                        e.n_waiting)
                           for e in self.router.replicas],
            n_free_slots=sum(e.pool.n_free for e in self.router.replicas),
            n_waiting=self.router.n_waiting,
            page_occupancy=sum(pages) / len(pages) if pages else 0.0,
            qos_tier=max((e.tier for e in self.router.replicas), default=0),
            submits_seen=self._submits_seen, progress=progress)

    def _emit_dones(self) -> None:
        for rid, r in self._rid_of.items():
            if r.finished and rid not in self._done_sent:
                self._done_sent.add(rid)
                sent = self._reported.get(rid, 0)
                self._outbox.append({
                    "kind": "done", "rid": rid,
                    "process_index": self.process_index,
                    "state": r.state,
                    "tokens": [int(t) for t in r.generated[sent:]]})
                self._reported[rid] = len(r.generated)

    def pump(self, now: float) -> List[Dict[str, Any]]:
        if not self.alive:
            return []
        if self._stopped:
            # drain shutdown: everything still buffered flushes at once
            # (delay no longer applies — the link is not "lagging", the
            # process is saying goodbye)
            out = list(self._outbox)
            self._outbox.clear()
            return out
        if self.router.n_waiting or self.router.n_active:
            self.router.step()
        self._pumps += 1
        if self._pumps % max(1, self.cfg.heartbeat_every) == 0:
            self._outbox.append(self._status().to_wire())
        self._emit_dones()
        out: List[Dict[str, Any]] = []
        while self._outbox and len(self._outbox) > self.delay:
            out.append(self._outbox.popleft())
        return out

    def final_report(self) -> Dict[str, Any]:
        return {
            "kind": "report", "process_index": self.process_index,
            "metrics": [e.metrics.to_payload()
                        for e in self.router.replicas],
            "fleet": {"decode_steps": int(sum(
                e.metrics.decode_steps for e in self.router.replicas)),
                "engine_steps": int(self.router.step_count)},
        }

    def stop(self) -> None:
        """Clean shutdown: flush pending dones, then the final metrics
        report and a bye — the opposite of kill(), which drops the
        outbox on the floor exactly like a crashed socket would."""
        if not self.alive or self._stopped:
            return
        self._emit_dones()
        self._outbox.append(self.final_report())
        self._outbox.append({"kind": "bye"})
        self._stopped = True

    def kill(self) -> None:
        self.alive = False
        self._outbox.clear()           # a crash sends nothing, ever


class RemoteProcess(ProcessHandle):
    """Worker behind an Endpoint (spawned by launch.fleet). `pump` just
    drains the socket: the worker advances itself."""

    def __init__(self, endpoint: Endpoint, process_index: int) -> None:
        self.endpoint = endpoint
        self.process_index = process_index

    @property
    def alive(self) -> bool:                       # type: ignore[override]
        return self.endpoint.alive

    def submit(self, msg: Dict[str, Any]) -> bool:
        return self.endpoint.send(msg)

    def pump(self, now: float) -> List[Dict[str, Any]]:
        return self.endpoint.poll()

    def stop(self) -> None:
        self.endpoint.send({"kind": "stop"})

    def kill(self) -> None:
        self.endpoint.send({"kind": "die"})


# ------------------------------------------------------------ worker server

class WorkerServer:
    """The serving loop of one fleet worker process: a ReplicaRouter
    over this process's engines, driven against the coordinator's
    Endpoint. Steps the router, answers submits, streams progress in
    heartbeats, and exits on `stop` (clean: final report) or `die`
    (fault injection: os._exit, no goodbye — the coordinator must learn
    from the heartbeat silence)."""

    def __init__(self, router, endpoint: Endpoint, process_index: int, *,
                 cfg: FleetConfig = FleetConfig()) -> None:
        # reuse LocalProcess's engine-facing half for the status/progress
        # bookkeeping; this class owns the socket loop around it
        self.local = LocalProcess(router, process_index, cfg=cfg)
        self.endpoint = endpoint
        self.cfg = cfg

    def serve_forever(self, idle_sleep: float = 0.002) -> None:
        import os as _os
        import time as _time
        self.endpoint.send({"kind": "hello",
                            "process_index": self.local.process_index,
                            "v": WIRE_VERSION,
                            "n_replicas": len(self.local.router.replicas)})
        while True:
            for msg in self.endpoint.poll():
                kind = msg.get("kind")
                if kind == "submit":
                    self.local.submit(msg)
                elif kind == "stop":
                    # drain: finish whatever is in flight, then report
                    while self.local.router.n_waiting \
                            or self.local.router.n_active:
                        for out in self.local.pump(0.0):
                            self.endpoint.send(out)
                    for out in self.local.pump(0.0):
                        self.endpoint.send(out)
                    self.endpoint.send(self.local.final_report())
                    self.endpoint.send({"kind": "bye"})
                    return
                elif kind == "die":
                    _os._exit(17)      # no goodbye, no cleanup: a crash
            had_work = bool(self.local.router.n_waiting
                            or self.local.router.n_active)
            for out in self.local.pump(0.0):
                self.endpoint.send(out)
            if not self.endpoint.alive:
                return                 # coordinator vanished: shut down
            if not had_work:
                _time.sleep(idle_sleep)

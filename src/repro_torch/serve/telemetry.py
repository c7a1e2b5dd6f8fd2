"""Live telemetry: counter/gauge/histogram registry, Prometheus, JSONL
(port of `repro.serve.telemetry`).

The tracer (serve.trace) answers "what happened to THIS request/dispatch";
telemetry answers "what does the fleet look like RIGHT NOW". A
`TelemetryRegistry` holds typed series; a `TelemetryExporter` snapshots a
sample function (engine_sample / router_sample below) on a cadence, pushing
every numeric value into the registry and appending one JSON line per
snapshot, so a run leaves a time series of `ServeMetrics` (plus page-pool
and router queue depths), not just the final summary.

Prometheus: `render_prometheus()` emits the text exposition format, and
`TelemetryExporter(port=...)` serves it from a stdlib `http.server`
endpoint (`GET /metrics`) on 127.0.0.1, on a daemon thread (port 0 picks a
free port, read back from `exporter.port`). No third-party client library.

Everything also works threadless: call `exporter.sample()` directly
instead of `start()`.
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_RE.sub("_", name)
    return ("_" + name) if name[:1].isdigit() else name


class Counter:
    """Monotonically increasing count (resets only with the process)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, "counters only go up"
        self.value += n

    def set(self, v: float) -> None:
        """Adopt an externally accumulated monotone total (the ServeMetrics
        counters already accumulate; re-counting them here would double)."""
        self.value = float(v)

    def render(self, name: str, labels: str = "") -> List[str]:
        tag = "{" + labels + "}" if labels else ""
        return [f"{name}{tag} {self.value:g}"]


class Gauge:
    """Point-in-time value (queue depth, occupancy, pages in use)."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def render(self, name: str, labels: str = "") -> List[str]:
        tag = "{" + labels + "}" if labels else ""
        return [f"{name}{tag} {self.value:g}"]


class Histogram:
    """Fixed-bucket histogram (cumulative, Prometheus-style `le` buckets)."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = (
            0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)) -> None:
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1

    def render(self, name: str, labels: str = "") -> List[str]:
        # `le` joins any shared labels inside the same brace set.
        pre = labels + "," if labels else ""
        tag = "{" + labels + "}" if labels else ""
        out = []
        for ub, c in zip(self.buckets, self.counts):
            out.append(f'{name}_bucket{{{pre}le="{ub:g}"}} {c}')
        out.append(f'{name}_bucket{{{pre}le="+Inf"}} {self.count}')
        out.append(f"{name}_sum{tag} {self.sum:g}")
        out.append(f"{name}_count{tag} {self.count}")
        return out


class TelemetryRegistry:
    """Named metric store with get-or-create accessors and rendering."""

    def __init__(self, prefix: str = "serve",
                 process_index: Optional[int] = None) -> None:
        self.prefix = prefix
        # several processes exporting on one host keep their series apart
        # by a process_index label; None renders no label and no braces
        self.process_index = process_index
        self._metrics: Dict[str, Tuple[Any, str]] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory: Callable[[], Any],
             help_: str) -> Any:
        name = _sanitize(name)
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = (factory(), help_)
            m = self._metrics[name][0]
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(name, Counter, help)
        assert isinstance(m, Counter), f"{name} already registered as {m.kind}"
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, Gauge, help)
        assert isinstance(m, Gauge), f"{name} already registered as {m.kind}"
        return m

    def histogram(self, name: str, buckets: Sequence[float] = (
            0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0),
            help: str = "") -> Histogram:
        m = self._get(name, lambda: Histogram(buckets), help)
        assert isinstance(m, Histogram), \
            f"{name} already registered as {m.kind}"
        return m

    def snapshot(self) -> Dict[str, float]:
        """Scalar view (histograms as _sum/_count) for JSONL snapshots."""
        out: Dict[str, float] = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, (m, _) in items:
            if isinstance(m, Histogram):
                out[f"{name}_sum"] = m.sum
                out[f"{name}_count"] = float(m.count)
            else:
                out[name] = m.value
        return out

    def render_prometheus(self) -> str:
        labels = ("" if self.process_index is None
                  else f'process_index="{self.process_index}"')
        lines: List[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, (m, help_) in items:
            full = f"{self.prefix}_{name}" if self.prefix else name
            if help_:
                lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {m.kind}")
            lines.extend(m.render(full, labels))
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- samplers

def engine_sample(engine) -> Dict[str, float]:
    """One engine's live picture: the full ServeMetrics report plus the
    queue/slot/page state a report() alone cannot show mid-run."""
    s = dict(engine.metrics.report())
    s["n_active"] = float(engine.pool.n_active)
    s["n_waiting"] = float(engine.n_waiting)
    s["n_slots"] = float(engine.cfg.n_slots)
    stats = engine.backend.page_stats()
    if stats is not None:
        s["pages_in_use_now"], s["pages_usable"] = map(float, stats)
    return s


def router_sample(router) -> Dict[str, float]:
    """Fleet picture: the pooled aggregate plus per-replica queue depths
    (the router's rebalance signal, and the first thing to look at when
    one replica backs up)."""
    s = dict(router.report())
    s["overflow_depth"] = float(len(router._overflow))
    for i, eng in enumerate(router.replicas):
        s[f"replica{i}_n_active"] = float(eng.pool.n_active)
        s[f"replica{i}_n_waiting"] = float(eng.n_waiting)
        s[f"replica{i}_alive"] = float(router.alive[i])
        s[f"replica{i}_tier"] = float(eng.tier)
    return s


# ---------------------------------------------------------------- exporter

# report() keys that accumulate monotonically -> Prometheus counters;
# everything else a sample produces is a point-in-time gauge.
_COUNTER_KEYS = frozenset((
    "tokens_generated", "decode_steps", "micro_steps", "idle_steps",
    "requests_completed", "rejected", "host_syncs_decode",
    "host_syncs_prefill", "spec_dispatches", "draft_proposed",
    "draft_accepted", "draft_rolled_back", "prefill_tokens_skipped",
    "pool_waits", "gather_bytes_avoided", "conversation_prefix_hits",
    "conversation_tokens_reused",
    "spills", "overflowed", "rebalanced", "router_steps",
    # resilience: QoS tier churn, shed/deadline accounting, failover
    "tier_demotions", "tier_promotions", "shed", "deadline_missed",
    "shed_pool_pressure", "failovers", "rejected_fleet", "replica_deaths",
    "restarts",
    # ineffectual-work ledger + quality probes (serve.ledger)
    "ledger_dispatches", "act_probe_elems", "act_zeros", "act_near_zeros",
    "act_groups", "act_kblocks", "act_dead_kblocks",
    "flops_dense", "flops_effective", "bytes_dense", "bytes_effective",
    "quality_probes", "host_syncs_quality", "trace_dropped",
))


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Exporter knobs."""

    interval: float = 1.0              # snapshot cadence, seconds
    port: Optional[int] = None         # Prometheus endpoint (0 = ephemeral)
    jsonl: Optional[str] = None        # append one JSON line per snapshot
    process_index: Optional[int] = None  # fleet label; None = unlabeled


class TelemetryExporter:
    """Cadenced snapshots of a sample function into a registry + JSONL,
    with an optional Prometheus scrape endpoint.

    sample_fn: () -> Dict[str, number] (wrap engine_sample/router_sample
    with the target bound). start() runs the cadence on a daemon thread
    and, with a port, the HTTP endpoint; stop() tears both down and takes
    one final snapshot so short runs always leave at least one line."""

    def __init__(self, sample_fn: Callable[[], Dict[str, float]],
                 cfg: TelemetryConfig = TelemetryConfig(), *,
                 registry: Optional[TelemetryRegistry] = None) -> None:
        self.sample_fn = sample_fn
        self.cfg = cfg
        self.registry = registry or TelemetryRegistry(
            process_index=cfg.process_index)
        self.n_samples = 0
        self.port: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None

    # -- one snapshot -------------------------------------------------------

    def sample(self) -> Dict[str, float]:
        s = self.sample_fn()
        for k, v in s.items():
            if not isinstance(v, (int, float)):
                continue
            if k in _COUNTER_KEYS:
                self.registry.counter(k).set(float(v))
            else:
                self.registry.gauge(k).set(float(v))
        self.n_samples += 1
        if self.cfg.jsonl:
            d = os.path.dirname(self.cfg.jsonl)
            if d:
                os.makedirs(d, exist_ok=True)
            ptag = ({} if self.registry.process_index is None
                    else {"process": self.registry.process_index})
            with open(self.cfg.jsonl, "a") as f:
                f.write(json.dumps({"ts": time.time(),
                                    "sample": self.n_samples,
                                    **ptag, **s}) + "\n")
        return s

    # -- cadence + endpoint -------------------------------------------------

    def start(self) -> "TelemetryExporter":
        if self.cfg.port is not None:
            self._start_server(self.cfg.port)
        try:
            self.sample()          # immediate first point: a scrape right
        except RuntimeError:       # after start() never sees an empty page
            pass                   # (a report() racing the serving thread)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval):
            try:
                self.sample()
            except RuntimeError:
                pass                     # a report() racing the serving
                #                          thread's dict updates: next tick

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.sample()                # final snapshot: short runs get >= 1
        except RuntimeError:
            pass                         # a report() racing the serving thread
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                self._server_thread.join(timeout=5.0)
            self._server = None
            self._server_thread = None

    def __enter__(self) -> "TelemetryExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- http ---------------------------------------------------------------

    def _start_server(self, port: int) -> None:
        registry = self.registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 (stdlib casing)
                if self.path.rstrip("/") in ("", "/metrics"):
                    body = registry.render_prometheus().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *a):     # scrapes must not spam stdout
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler)
        self.port = self._server.server_address[1]
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="telemetry-http")
        self._server_thread.start()

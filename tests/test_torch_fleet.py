"""Port parity, fleet serving (`repro_torch.serve.router.FleetRouter` over
`repro_torch.serve.control`'s process faces, and `launch/fleet.py`): on the
smoke h2o-danube with weights carried into both packages, a 2-process
LocalProcess fleet is greedy-token-identical to the port's single engine
and to JAX's, with snapshots delayed 2 pumps and across a process death (a
zombie status ignored); `ServeMetrics.to_payload` / `from_payload` round
trip, pool and report as JAX's do; JAX's FleetRouter over the port's
LocalProcess handles serves the same tokens (the wire and the payload
interoperate); the trace process stamp in the JSONL and Chrome exports
byte for byte as JAX's; the launcher as a user starts it, with a death
injected; its refusals; and no JAX in the fleet's modules. On the card, a
2-LocalProcess fleet equals one card engine."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_serve_parity import DANUBE, J, P, models, needs_jax, torch
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.launch import fleet as F
from repro_torch.serve.trace import chrome_events, export_jsonl

ROOT = Path(__file__).resolve().parent.parent


def _ecfg(pkg, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_waiting", 16)
    if pkg is P:
        kw.setdefault("device", "cpu")
    return pkg.EngineConfig(**kw)


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(4, 9)))
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference(framework, n, seed, gen):
    """One engine's greedy tokens on `n` seeded prompts ("jax" or "port",
    the same carried weights)."""
    pkg, m = (J, models(DANUBE)[0]) if framework == "jax" \
        else (P, models(DANUBE)[1])
    eng = pkg.InferenceEngine(m, _ecfg(pkg))
    reqs = [eng.submit(p, gen) for p in _prompts(m.cfg.vocab, n, seed)]
    eng.run()
    return [list(map(int, r.generated)) for r in reqs]


def _local_fleet(n_processes, fcfg=None, delay=0, router_pkg=P):
    """A FleetRouter of `router_pkg` over the port's LocalProcess handles,
    each a one-replica ReplicaRouter of the port's model."""
    fcfg = fcfg or P.FleetConfig(heartbeat_every=1, staleness=8.0,
                                 heartbeat_timeout=25.0)
    m = models(DANUBE)[1]
    procs = [P.LocalProcess(P.ReplicaRouter.build(m, _ecfg(P), 1),
                            process_index=i, cfg=fcfg, delay=delay)
             for i in range(n_processes)]
    return router_pkg.FleetRouter(procs, cfg=fcfg)


def _serve(fleet, n, seed, gen):
    reqs = [fleet.submit(p, gen)
            for p in _prompts(models(DANUBE)[1].cfg.vocab, n, seed)]
    fleet.run()
    fleet.stop()
    return reqs


# ------------------------------------------------------------ token identity

@needs_jax
def test_two_process_fleet_token_identical_to_single_engine():
    fleet = _local_fleet(2)
    reqs = _serve(fleet, 6, 0, 6)
    want = _reference("port", 6, 0, 6)
    assert want == _reference("jax", 6, 0, 6)
    assert [list(r.tokens) for r in reqs] == want
    # and the work actually spread: both processes served something
    assert len({r.process for r in reqs}) == 2
    rep = fleet.report()
    assert rep["n_processes"] == 2.0
    assert rep["fleet_requests_completed"] == 6.0
    assert rep["fleet_tokens"] == float(sum(len(t) for t in want))
    assert rep["fleet_steps"] > 0 and rep["tokens_per_fleet_step"] > 0
    assert rep["fleet_failovers"] == 0.0
    assert rep["tokens_generated"] == rep["fleet_tokens"]


@needs_jax
def test_delayed_snapshots_fleet_still_token_identical():
    """Every control message lagged 2 pumps: placement runs on stale
    snapshots + credits; tokens must not change, and admission must not
    collapse onto one process."""
    fleet = _local_fleet(2, delay=2)
    reqs = _serve(fleet, 6, 1, 6)
    assert [list(r.tokens) for r in reqs] == _reference("jax", 6, 1, 6)
    assert len({r.process for r in reqs}) == 2


# ------------------------------------------------------------------ failover

@needs_jax
def test_process_death_fails_over_token_identical():
    """Kill one process mid-generation: silence crosses the heartbeat
    horizon, its unfinished requests re-prefill (prompt + accumulated
    progress) on the survivor, and greedy decode makes the final streams
    equal a single engine's. A zombie status is counted, never folded
    in."""
    fcfg = P.FleetConfig(heartbeat_every=1, staleness=4.0,
                         heartbeat_timeout=6.0)
    fleet = _local_fleet(2, fcfg=fcfg)
    reqs = [fleet.submit(p, 12)
            for p in _prompts(models(DANUBE)[1].cfg.vocab, 6, 2)]
    victim = None
    for _ in range(200):
        fleet.step()
        mid = [r.process for r in reqs
               if r.process >= 0 and not r.finished and r.tokens]
        if mid and len({r.process for r in reqs if r.process >= 0}) == 2:
            victim = max(mid)
            break
    assert victim is not None, "fleet never reached mid-generation state"
    fleet.processes[victim].kill()
    fleet.run()
    fleet.stop()
    assert [list(r.tokens) for r in reqs] == _reference("jax", 6, 2, 12)
    rep = fleet.report()
    assert rep["fleet_failovers"] >= 1
    assert rep["processes_dead"] == 1.0
    assert victim in fleet.state.dead
    # the survivor's engine counted each re-homed request once
    assert rep["failovers"] == rep["fleet_failovers"]
    zombie = P.ProcessStatus(process_index=victim, seq=10_000, step=0,
                             replica_loads=[0], n_free_slots=4, n_waiting=0,
                             page_occupancy=0.0, qos_tier=0, submits_seen=0,
                             progress={str(reqs[0].rid): [1, 2, 3]})
    before = [list(r.tokens) for r in reqs]
    fleet._handle(victim, zombie.to_wire())
    assert [list(r.tokens) for r in reqs] == before
    assert fleet.state.resurrections_ignored >= 1


@needs_jax
def test_jax_fleet_router_over_port_processes():
    """JAX's FleetRouter admits, fails over and pools reports over the
    port's LocalProcess handles: the port's status, done and report
    messages (and its metrics payloads) are what JAX's coordinator reads."""
    fcfg = J.FleetConfig(heartbeat_every=1, staleness=4.0,
                         heartbeat_timeout=6.0)
    fleet = _local_fleet(2, fcfg=fcfg, router_pkg=J)
    reqs = [fleet.submit(p, 12)
            for p in _prompts(models(DANUBE)[1].cfg.vocab, 6, 2)]
    for _ in range(200):
        fleet.step()
        if any(r.process == 1 and not r.finished and r.tokens
               for r in reqs):
            break
    fleet.processes[1].kill()
    fleet.run()
    fleet.stop()
    assert [list(r.tokens) for r in reqs] == _reference("jax", 6, 2, 12)
    rep = fleet.report()
    assert rep["processes_dead"] == 1.0 and rep["fleet_failovers"] >= 1
    assert rep["tokens_generated"] > 0


# ---------------------------------------------------- fleet-pooled metrics

@needs_jax
def test_metrics_payload_roundtrip_and_aggregate():
    m = models(DANUBE)[1]
    eng = P.InferenceEngine(m, _ecfg(P))
    for p in _prompts(m.cfg.vocab, 3, seed=4):
        eng.submit(p, 4)
    eng.run()
    # a tensor the port keeps (a ledger buffer, say) leaves as numbers
    eng.metrics.probe = torch.tensor([1, 2], dtype=torch.int32)
    payload = json.loads(json.dumps(eng.metrics.to_payload()))
    assert "t0" not in payload and payload["probe"] == [1, 2]
    back = P.ServeMetrics.from_payload(payload)
    a, b = eng.metrics.report(), back.report()
    for k in ("tokens_generated", "requests_completed", "decode_steps",
              "latency_steps_p99", "ttft_steps_p50", "host_syncs_decode"):
        assert a[k] == b[k], k
    assert all(r.submit_mono == r.first_token_time == r.finish_time == 0.0
               for r in back.records.values())
    assert back.records.keys() == eng.metrics.records.keys()
    agg = P.ServeMetrics.aggregate([eng.metrics, back])
    assert agg["tokens_generated"] == 2 * a["tokens_generated"]
    # JAX rebuilds the same payload into the same report
    jback = J.ServeMetrics.from_payload(payload)
    jrep = jback.report()
    assert b.keys() == jrep.keys()
    for k in ("tokens_generated", "requests_completed", "decode_steps",
              "latency_steps_p50", "ttft_steps_p99", "mean_occupancy"):
        assert b[k] == jrep[k], k
    assert J.ServeMetrics.aggregate([jback, jback]).keys() == agg.keys()


# ------------------------------------------------------ trace process stamp

@needs_jax
@pytest.mark.parametrize("process", [None, 3])
def test_trace_process_stamp_matches_jax(tmp_path, process):
    """A fleet worker's tracer stamps its process into the JSONL meta line
    and every event, and takes the Chrome pid block process x 4096 +
    replica: both byte for byte as JAX's exports of the same events.
    Outside a fleet (None) no key appears at all."""
    m = models(DANUBE)[1]
    eng = P.InferenceEngine(m, _ecfg(P, trace=P.TraceConfig()))
    for p in _prompts(m.cfg.vocab, 2, seed=5):
        eng.submit(p, 3)
    eng.run()
    tr = eng.trace
    tr.replica, tr.process = 1, process
    jtr = J.Tracer(J.TraceConfig(capacity=tr.cfg.capacity), replica=1)
    jtr.process, jtr.epoch_wall, jtr.dropped = process, tr.epoch_wall, 0
    jtr.events.extend(tr.events)
    export_jsonl([tr], str(tmp_path / "p.jsonl"))
    J.export_jsonl([jtr], str(tmp_path / "j.jsonl"))
    got = (tmp_path / "p.jsonl").read_bytes()
    assert got == (tmp_path / "j.jsonl").read_bytes()
    lines = [json.loads(x) for x in got.splitlines()]
    if process is None:
        assert all("process" not in x for x in lines)
    else:
        assert all(x["process"] == process for x in lines)
    from repro.serve.trace import chrome_events as jchrome
    evs = chrome_events(tr)
    assert evs == jchrome(jtr)
    assert evs[0]["pid"] == (1 if process is None else process * 4096 + 1)
    assert evs[0]["args"]["name"] == ("replica 1" if process is None
                                      else f"process {process} replica 1")


# --------------------------------------------------------------- launcher

def _env():
    # one intra-op thread in every process: smoke-sized ops run far faster
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


def test_fleet_cli_with_death_on_cpu():
    """`python -m repro_torch.launch.fleet` as a user starts it: two
    worker processes, one killed mid-trace; exit 0 means the outputs
    equal its in-coordinator engine's and one failover happened."""
    cmd = [sys.executable, "-m", "repro_torch.launch.fleet", "--device",
           "cpu", "--processes", "2", "--requests", "6", "--inject-death"]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# injected death: process" in proc.stdout
    assert "token-identical vs single: True" in proc.stdout
    assert "dead 1" in proc.stdout


@pytest.mark.parametrize("flags", [["--jax-coordinator", "auto"],
                                   ["--devices-per-process", "2",
                                    "--replicas", "2"]])
def test_fleet_coordinator_and_devices_per_process(flags, monkeypatch):
    """`--jax-coordinator` joins the workers into one process group, and
    `--devices-per-process 2` gives each worker two devices (on the CPU
    every replica is on `cpu`); either way the fleet gives the single
    engine's tokens (main exits 0 only then)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert F.main(["--device", "cpu", "--requests", "4"] + flags) == 0


def test_fleet_cli_block_workers_with_death_on_cpu():
    """Workers that own two devices each, joined into one group: 2 blocks
    of 2 gloo ranks (a leader with the control socket and a follower it
    relays to), 2 replicas a block; one block killed mid-trace. The
    outputs stay the in-coordinator engine's."""
    cmd = [sys.executable, "-m", "repro_torch.launch.fleet", "--device",
           "cpu", "--processes", "2", "--requests", "6", "--replicas", "2",
           "--devices-per-process", "2", "--jax-coordinator", "auto",
           "--inject-death"]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# injected death: process" in proc.stdout
    assert "fleet 2x2:" in proc.stdout and "dead 1" in proc.stdout
    assert "token-identical vs single: True" in proc.stdout


@pytest.mark.parametrize("case", ["zero", "fewer_than_replicas",
                                  "block_split", "cards"])
def test_devices_per_process_refusals(case, monkeypatch):
    """What a worker cannot own is refused before any process starts: no
    device, fewer devices than replicas, a block of ranks the replicas do
    not split, and on the card a host with fewer cards than processes x
    D (no fall-back to a shared device)."""
    started = []
    monkeypatch.setattr(F.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    kw = {"zero": dict(devices_per_process=-1, device="cpu"),
          "fewer_than_replicas": dict(devices_per_process=2,
                                      replicas_per_process=3, device="cpu"),
          "block_split": dict(devices_per_process=2, replicas_per_process=3,
                              jax_coordinator="auto", device="cpu"),
          "cards": dict(devices_per_process=2, device="cuda")}[case]
    if case == "cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    match = {"zero": ">= 1", "fewer_than_replicas": "3 replicas",
             "block_split": "does not divide",
             "cards": "need 4 cards; this host has 1"}[case]
    with pytest.raises(ValueError, match=match):
        F.spawn_fleet(2, **kw)
    assert not started


@pytest.mark.cuda
def test_one_card_refuses_two_devices_per_process():
    """On a one-card host a worker that owns two cards is refused with
    ValueError, naming both counts, before any worker starts."""
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a host with exactly one card")
    with pytest.raises(ValueError, match="need 2 cards; this host has 1"):
        F.spawn_fleet(1, devices_per_process=2, device="cuda")


def test_spawn_fleet_fails_fast_on_a_dead_worker(monkeypatch):
    """A worker that exits before its hello (here: an unknown arch) fails
    the spawn at once, naming its exit code, and leaves no process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="exited with code"):
        F.spawn_fleet(2, arch="no-such-arch", device="cpu",
                      hello_timeout=120.0)


def test_fleet_modules_import_no_jax():
    code = ("import sys, repro_torch.launch.fleet, "
            "repro_torch.serve.control, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   timeout=120)


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_cuda_local_fleet_equals_one_engine(cuda_device):
    """Two LocalProcess handles on the card (each a one-replica router of
    graphed engines over one model) give one card engine's greedy
    tokens."""
    m = P.ModelRegistry().load(DANUBE)
    cfg = P.EngineConfig(n_slots=4, max_len=64, max_waiting=16,
                         decode_chunk=2)
    prompts = _prompts(m.cfg.vocab, 6, seed=0)
    eng = P.InferenceEngine(m, cfg)
    want = [eng.submit(p, 6) for p in prompts]
    eng.run()
    fcfg = P.FleetConfig(heartbeat_every=1, staleness=8.0,
                         heartbeat_timeout=25.0)
    fleet = P.FleetRouter([P.LocalProcess(P.ReplicaRouter.build(m, cfg, 1),
                                          process_index=i, cfg=fcfg)
                           for i in range(2)], cfg=fcfg)
    reqs = [fleet.submit(p, 6) for p in prompts]
    fleet.run()
    fleet.stop()
    assert [list(r.tokens) for r in reqs] == \
        [list(map(int, r.generated)) for r in want]
    assert len({r.process for r in reqs}) == 2

"""Fleet launcher: N serving processes + the cross-process control plane
(port of `repro.launch.fleet`).

This module SPAWNS the processes that serve.control / serve.router
coordinate. Two entry modes share one file so the wire protocol and its
two ends can never drift apart:

  coordinator (default)  binds a ControlListener, spawns N worker
                         subprocesses (fresh interpreters, never a fork of
                         a process that touched CUDA), waits for their
                         hellos, and builds a FleetRouter over the
                         RemoteProcess handles.
  --worker               one serving process: model load (weights from
                         `--seed`), `LocalBackend` replicas through
                         `ReplicaRouter.build`, a warm-up of every replica,
                         then WorkerServer against the coordinator's
                         socket.

`python -m repro_torch.launch.fleet --processes 2` runs the built-in smoke:
a Poisson trace through the 2-process fleet, greedy outputs checked token
for token against a single in-coordinator engine; `--inject-death` kills
one worker mid-trace and requires the heartbeat-timeout failover to keep
the outputs identical. It runs on the card (`--device cuda`, the default:
every worker shares the one GPU, each holding its own copy of the
weights) or, with `--device cpu`, through the kernels' plain versions;
`--full` loads the published config (full width and depth).

`--jax-coordinator HOST:PORT` (or `auto` to spawn_fleet, which picks a
free local port) joins the workers into one torch.distributed process
group (the flag keeps the JAX package's name): each worker is a rank and
serves its replicas through `DistributedBackend` on its own rank's
one-device mesh (`launch.mesh.process_meshes`), so the data plane never
crosses a process; the control plane moves requests and results as
without the flag. Not ported: `--devices-per-process > 1` (a worker that
owns several devices) raises NotImplementedError naming ROADMAP.md item
14.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

# Wall-clock control-plane horizons for REAL subprocess fleets (the
# coordinator paces its step loop with PACE-second sleeps, so these are
# roughly seconds/PACE steps). Deterministic tests use tighter step-clock
# FleetConfigs on LocalProcess handles instead.
PACE = 0.002
WALL_STALENESS = 400.0          # ~0.8 s of snapshot age tolerated
WALL_HEARTBEAT_TIMEOUT = 2500.0  # ~5 s of silence before death verdict

MULTI_DEVICE = "ROADMAP.md queue 1, item 14 (multi-device fleet workers)"


def worker_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--worker", action="store_true",
                    help="run as one fleet serving process (spawned by the "
                         "coordinator; rarely typed by hand)")
    ap.add_argument("--connect", default="",
                    help="coordinator control address host:port")
    ap.add_argument("--process-index", type=int, default=0)
    ap.add_argument("--processes", type=int, default=2,
                    help="fleet size (how many workers the coordinator "
                         "spawns)")
    ap.add_argument("--jax-coordinator", default="",
                    help="HOST:PORT where the workers join one "
                         "torch.distributed process group (the JAX "
                         "package's flag name)")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, shared by every worker) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and trace seed")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--decode-chunk", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas PER PROCESS (sharing the "
                         "process's weights)")
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help=f"devices per worker (> 1 not ported: "
                         f"{MULTI_DEVICE})")
    ap.add_argument("--heartbeat-every", type=int, default=2)


def refuse_unported(devices_per_process: int) -> None:
    """Refuse, before any process starts, what the port does not run."""
    if devices_per_process > 1:
        raise NotImplementedError(
            "--devices-per-process > 1: fleet workers that own several "
            f"devices are {MULTI_DEVICE} of the port, not ported yet")


def _warm_replicas(router, model) -> None:
    """Serve before hello: run one throwaway request through EVERY replica
    engine (its first admission, its first graph replay and the kernels'
    first loads). The worker's serve loop is single-threaded, so a slow
    first step after admission would be heartbeat SILENCE, and the
    coordinator would declare a healthy process dead. Metrics and step
    counters reset after, so reports describe only real traffic."""
    from repro_torch.serve import ServeMetrics
    for eng in router.replicas:
        eng.submit([1, 2, 3], 2)
        eng.run()
        eng.metrics = ServeMetrics()
    router.step_count = 0


def worker_entry(args) -> None:
    """One fleet serving process, start to finish: model load and engine
    build, the warm-up, the socket loop last."""
    from repro_torch.serve import (EngineConfig, FleetConfig, ModelRegistry,
                                   ReplicaRouter, WorkerServer, connect)

    from repro_torch.serve import DistributedBackend, ensure_distributed
    if args.jax_coordinator:
        ensure_distributed(args.jax_coordinator, args.processes,
                           args.process_index, device=args.device)
    model = ModelRegistry().load(args.arch, seed=args.seed,
                                 smoke=not args.full, device=args.device)
    cfg = EngineConfig(n_slots=args.slots, max_len=args.max_len,
                       decode_chunk=args.decode_chunk,
                       max_waiting=args.slots, device=args.device)
    factory = None
    if args.jax_coordinator:
        # every replica on this worker's own rank (they share its device)
        def factory(i: int):
            return DistributedBackend(mesh_shape=(1, 1), device=args.device)
    router = ReplicaRouter.build(model, cfg, args.replicas,
                                 backend_factory=factory)
    for eng in router.replicas:
        eng.trace.process = args.process_index   # tag before any event
    _warm_replicas(router, model)
    endpoint = connect(args.connect)
    WorkerServer(router, endpoint, args.process_index,
                 cfg=FleetConfig(heartbeat_every=args.heartbeat_every,
                                 staleness=WALL_STALENESS,
                                 heartbeat_timeout=WALL_HEARTBEAT_TIMEOUT)
                 ).serve_forever()
    endpoint.close()


# --------------------------------------------------------------- coordinator


def _await_hello(endpoint, timeout: float = 120.0) -> Dict[str, Any]:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        for msg in endpoint.poll():
            if msg.get("kind") == "hello":
                return msg
        if not endpoint.alive:
            raise RuntimeError("worker hung up before hello")
        time.sleep(0.01)
    raise TimeoutError("no hello from worker within timeout")


def _accept(listener, workers: List[subprocess.Popen], timeout: float):
    """The next worker connection; a worker that exits before it connects
    fails the spawn at once instead of after the whole timeout."""
    import socket
    deadline = time.monotonic() + timeout
    while True:
        for i, w in enumerate(workers):
            if w.poll() is not None:
                raise RuntimeError(f"fleet worker {i} exited with code "
                                   f"{w.returncode} before its hello")
        try:
            return listener.accept(timeout=min(
                1.0, max(0.01, deadline - time.monotonic())))
        except socket.timeout:
            if time.monotonic() >= deadline:
                raise TimeoutError("no fleet worker connected within "
                                   f"{timeout} s") from None


class Fleet:
    """A spawned local fleet: worker Popens + the FleetRouter over them.
    Context-manages cleanup so a failed run never leaks processes."""

    def __init__(self, router, workers: List[subprocess.Popen],
                 listener) -> None:
        self.router = router
        self.workers = workers
        self.listener = listener

    def drive(self, max_seconds: float = 600.0) -> None:
        """Pump the router until every request finishes. Wall-paced: the
        coordinator's `now` advances one step per PACE sleep, which is
        what calibrates WALL_* horizons to seconds."""
        t0 = time.monotonic()
        while any(not r.finished for r in self.router.requests.values()):
            if time.monotonic() - t0 > max_seconds:
                raise TimeoutError("fleet did not drain in time")
            live = [pi for pi in self.router.processes
                    if pi not in self.router.state.dead]
            if not live:
                raise RuntimeError("every fleet process died")
            self.router.step()
            time.sleep(PACE)

    def shutdown(self) -> None:
        try:
            self.router.stop()
        finally:
            for w in self.workers:
                try:
                    w.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    w.kill()
                    w.wait()
            self.listener.close()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
        return None


def spawn_fleet(n_processes: int, *, arch: str = "h2o-danube-1.8b",
                n_slots: int = 4, max_len: int = 96, decode_chunk: int = 4,
                replicas_per_process: int = 1,
                devices_per_process: int = 0,
                jax_coordinator: str = "", heartbeat_every: int = 2,
                cfg=None, hello_timeout: float = 300.0,
                device: str = "cuda", full: bool = False,
                seed: int = 0) -> Fleet:
    """Spawn `n_processes` worker subprocesses and return a Fleet whose
    router admits across them. Each worker is a fresh interpreter
    (`-m repro_torch.launch.fleet --worker`) with `src/` on its
    PYTHONPATH. On the card every kernel is built here, before the first
    worker starts, so the workers only load what this process built
    (two cold workers would otherwise race on one source's build log)."""
    from repro_torch.serve import FleetConfig, FleetRouter
    from repro_torch.serve.control import ControlListener, RemoteProcess
    from repro_torch.serve.registry import check_device

    refuse_unported(devices_per_process)
    if jax_coordinator == "auto":
        from repro_torch.launch.mesh import free_port
        jax_coordinator = f"127.0.0.1:{free_port()}"
    if check_device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    listener = ControlListener()
    repo_src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    workers: List[subprocess.Popen] = []
    try:
        for i in range(n_processes):
            env = dict(os.environ)
            env["PYTHONPATH"] = repo_src + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
                else "")
            cmd = [sys.executable, "-m", "repro_torch.launch.fleet",
                   "--worker", "--connect", listener.address,
                   "--process-index", str(i),
                   "--processes", str(n_processes),
                   "--arch", arch, "--device", device, "--seed", str(seed),
                   "--slots", str(n_slots), "--max-len", str(max_len),
                   "--decode-chunk", str(decode_chunk),
                   "--replicas", str(replicas_per_process),
                   "--heartbeat-every", str(heartbeat_every)]
            if full:
                cmd.append("--full")
            if jax_coordinator:
                cmd += ["--jax-coordinator", jax_coordinator]
            workers.append(subprocess.Popen(cmd, env=env))
        handles = []
        for _ in range(n_processes):
            ep = _accept(listener, workers, hello_timeout)
            hello = _await_hello(ep, timeout=hello_timeout)
            handles.append(RemoteProcess(ep, int(hello["process_index"])))
        handles.sort(key=lambda h: h.process_index)
        cfg = cfg or FleetConfig(heartbeat_every=heartbeat_every,
                                 staleness=WALL_STALENESS,
                                 heartbeat_timeout=WALL_HEARTBEAT_TIMEOUT)
        return Fleet(FleetRouter(handles, cfg=cfg), workers, listener)
    except BaseException:
        for w in workers:
            w.kill()
            w.wait()
        listener.close()
        raise


# --------------------------------------------------------------------- smoke

def run_smoke(args) -> int:
    """2-process fleet vs one in-coordinator engine on the same Poisson
    trace: token identity is the pass/fail; topology + throughput print.
    Optionally (--inject-death) kills one worker mid-trace and requires
    the heartbeat-timeout failover to keep the outputs token-identical."""
    import gc

    import numpy as np
    import torch
    from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry

    model = ModelRegistry().load(args.arch, seed=args.seed,
                                 smoke=not args.full, device=args.device)
    rng = np.random.default_rng(args.seed)
    trace = []
    t = 0.0
    # death injection needs every request mid-generation long enough for
    # the kill to land: stretch the decode phase, same trace both sides
    gen_extra = 16 if args.inject_death else 0
    for _ in range(args.requests):
        t += rng.exponential(0.75)
        trace.append((int(t), rng.integers(0, model.cfg.vocab,
                                           int(rng.integers(4, 12))),
                      int(rng.integers(4, 10)) + gen_extra))

    eng = InferenceEngine(model, EngineConfig(
        n_slots=args.slots, max_len=args.max_len,
        decode_chunk=args.decode_chunk, device=args.device))
    ref = [eng.submit(p, g, arrival_step=a) for a, p, g in trace]
    eng.run()
    ref_toks = [list(r.generated) for r in ref]
    # the workers hold their own copies of the weights: this one goes
    # before they load theirs
    del eng, ref, model
    gc.collect()
    if args.device != "cpu":
        torch.cuda.empty_cache()

    with spawn_fleet(args.processes, arch=args.arch, n_slots=args.slots,
                     max_len=args.max_len, decode_chunk=args.decode_chunk,
                     replicas_per_process=args.replicas,
                     jax_coordinator=args.jax_coordinator,
                     device=args.device, full=args.full,
                     seed=args.seed) as fleet:
        reqs = [fleet.router.submit(p, g, arrival_step=a)
                for a, p, g in trace]
        if args.inject_death:
            # crash a process while it is MID-GENERATION: the victim is
            # picked live (a process observed with an unfinished request
            # that has accumulated tokens); a fixed victim races, e.g. a
            # slow-starting worker that never got any requests homed
            victim = None
            deadline = time.monotonic() + 60.0
            while victim is None:
                alive = [r.process for r in reqs
                         if r.process >= 0 and not r.finished
                         and len(r.tokens)]
                if alive:
                    victim = max(alive)
                    break
                if all(r.finished for r in reqs):
                    raise RuntimeError(
                        "trace drained before death injection: grow "
                        "--requests or --gen to widen the window")
                fleet.router.step()
                time.sleep(PACE)
                if time.monotonic() > deadline:
                    raise TimeoutError("no progress before death injection")
            fleet.router.processes[victim].kill()
            print(f"# injected death: process {victim}")
        fleet.drive()
        fleet.router.stop()
        rep = fleet.router.report()

    fleet_toks = [list(r.tokens) for r in reqs]
    identical = fleet_toks == ref_toks
    print(f"fleet {args.processes}x{args.replicas}: "
          f"{int(rep.get('fleet_requests_completed', 0))} reqs, "
          f"{int(rep.get('fleet_tokens', 0))} toks | "
          f"tokens/fleet-step {rep.get('tokens_per_fleet_step', 0):.2f} | "
          f"failovers {int(rep.get('fleet_failovers', 0))}, "
          f"dead {int(rep.get('processes_dead', 0))}, "
          f"resurrections ignored "
          f"{int(rep.get('resurrections_ignored', 0))} | "
          f"token-identical vs single: {identical}")
    if args.inject_death and not rep.get("fleet_failovers", 0):
        print("# FAIL: death injected but no failover happened")
        return 1
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"identical": identical, "report": rep}, f, indent=2)
            f.write("\n")
    return 0 if identical else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Spawn a local N-process serving fleet (or run as one "
                    "of its workers).")
    worker_flags(ap)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--inject-death", action="store_true",
                    help="smoke: kill one worker mid-trace and require "
                         "token-identical failover")
    ap.add_argument("--out", default="", help="write smoke result JSON")
    args = ap.parse_args(argv)
    refuse_unported(args.devices_per_process)
    if args.worker:
        if not args.connect:
            ap.error("--worker requires --connect host:port")
        worker_entry(args)
        return 0
    return run_smoke(args)


if __name__ == "__main__":
    sys.exit(main())

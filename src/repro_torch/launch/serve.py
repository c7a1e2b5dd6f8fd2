"""Serving launcher: the continuous-batching engine over packed Kratos
weights (port of `repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --requests 8 --prompt-len 32 --gen 32 [--device cuda|cpu] [--full] \
      [--sparsity 0.5 --bits 8 --impl tree] [--slots 4] [--static] \
      [--temperature 0.8] [--decode-chunk K] [--host-loop] \
      [--speculate 4 --draft-bits 8 [--draft-sparsity S] \
       [--draft-keep-layers N]] \
      [--page-size P [--n-pages N] [--no-prefix-cache]] \
      [--replicas N] [--max-waiting M] \
      [--trace-out T.jsonl] [--trace-chrome T.json] [--profile-dir D] \
      [--telemetry-port P] [--telemetry-jsonl S.jsonl] \
      [--ledger [--ledger-threshold T] [--quality-every N]] \
      [--tiers 8:0.5,8:0.75 [--qos-*]] [--deadline-steps D] \
      [--pool-wait-retries R] [--auto-restart] [--processes N] \
      [--mesh D,M [--dry-run]] \
      [--coordinator HOST:PORT --num-processes N --process-id I]

Loads the arch through the serve registry (weights initialised from
`--seed` and packed once), submits `--requests` generation requests with a
small prompt-length jitter drawn from `np.random.default_rng(seed)`, and
drives the engine until the trace drains; a bounded waiting deque
(`--max-waiting`) is met by stepping the engine until the submit is
accepted, as a client backs off. It runs on the card (`--device cuda`, the
default; every decode dispatch replays a CUDA graph) and, with `--device
cpu`, through the kernels' plain versions. The reduced smoke config is the
default; `--full` loads the published config (full width and depth).

`--static` admits through the drain-then-refill `StaticScheduler` instead
of the continuous one. `--replicas N` fronts N engines with the
`ReplicaRouter` (one card: they share the model's weights),
`--auto-restart` rebuilds a replica the router marked dead. `--page-size P`
switches the KV cache to the page pool with prefix reuse where the arch
supports it; `--speculate K` derives a self-draft at the `--draft-*` point
and runs the fused propose-then-verify cycle. `--tiers` keeps a QoS ladder
resident (serve.qos, hysteresis via `--qos-*`), `--deadline-steps` sheds
doomed work, `--pool-wait-retries` bounds page-pool waits, `--ledger`
carries the ineffectual-work ledger (serve.ledger).

Observability: `--trace-out` / `--trace-chrome` switch the engines to the
ring-buffer tracer (serve.trace) and export every lifecycle and dispatch
edge as JSONL / chrome://tracing JSON after the run; `--profile-dir`
brackets the first N traced dispatches with torch.profiler;
`--telemetry-port` serves Prometheus text at /metrics during the run and
`--telemetry-jsonl` appends one metrics snapshot per interval
(serve.telemetry).

Fleet serving: `--processes N` (N > 1) serves through a local fleet: N
worker processes spawned by launch.fleet, each loading the weights from
`--seed` and serving its own engines (`--replicas` each), fronted by the
FleetRouter over the control plane (serve.control). The coordinator loads
no weights; its prompts are drawn from the arch's vocab.

Mesh serving: `--mesh d,m` serves through `serve.ShardedBackend` on a
(data=d, model=m) mesh of d * m ranks, one process each (torch.distributed:
gloo with `--device cpu`, NCCL on the card). Under torchrun (WORLD_SIZE
set) the launcher joins that group, with `--coordinator HOST:PORT
--num-processes N --process-id I` the group at that address; otherwise it
spawns the d * m ranks itself (on the card, no more than the visible
cards). Every rank runs the same engine; rank 0 prints. `--replicas N`
splits 'data' into N disjoint submeshes, one ShardedBackend each, behind
the ReplicaRouter (launch.mesh.replica_meshes). Greedy tokens equal the
same command's without `--mesh`. `--dry-run` prints, for the mesh and
without a process group, one PartitionSpec per cache, page and
decode-state leaf (the JAX package's specs, distributed.sharding) and one
decode dispatch's FLOPs and bytes per device under the port's placement,
counted on the plain path (analysis.cost); with `--processes N` or
`--coordinator` it prints the fleet topology instead
(launch.mesh.plan_fleet_topology / fleet_topology) and loads no weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import List, Optional

import numpy as np

from repro_torch import configs as C
from repro_torch.core.kratos import KratosSpec
from repro_torch.serve import (DraftSpec, EngineConfig, EngineSaturated,
                               InferenceEngine, LedgerConfig, LocalBackend,
                               ModelRegistry, QoSConfig, ReplicaRouter,
                               ShardedBackend, StaticScheduler,
                               TelemetryConfig, TelemetryExporter,
                               TraceConfig, engine_sample, export_chrome,
                               export_jsonl, parse_tiers, router_sample)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache positions per slot (0 = prompt+gen+slack)")
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--bits", type=int, default=0, help="0 = native f32")
    ap.add_argument("--act-bits", type=int, default=0, help="8 => w8a8")
    ap.add_argument("--impl", default="tree", choices=("tree", "systolic"))
    ap.add_argument("--block", type=int, default=8, help="sparsity bk=bn")
    ap.add_argument("--static", action="store_true",
                    help="lock-step drain-then-refill baseline scheduler")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="K micro-steps per device-resident decode dispatch "
                         "(throughput up, admission latency up)")
    ap.add_argument("--host-loop", action="store_true",
                    help="host decode loop (per-step logits pull + numpy "
                         "sampling) instead of the device-resident one")
    ap.add_argument("--speculate", type=int, default=0,
                    help="K-token self-draft speculation per dispatch "
                         "(derives a draft artifact from the same weights; "
                         "replaces --decode-chunk; greedy output unchanged)")
    ap.add_argument("--draft-bits", type=int, default=8,
                    help="draft weight bits for --speculate (0 = native)")
    ap.add_argument("--draft-sparsity", type=float, default=0.0,
                    help="draft sparsity for --speculate (bk=bn=8 blocks)")
    ap.add_argument("--draft-keep-layers", type=int, default=0,
                    help="truncate the draft to its first N layers (0=all)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="block-paged KV pool with P positions per page "
                         "(0 = slab); enables cross-request prefix reuse "
                         "where the arch supports it")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page-pool size for --page-size (0 = slab-"
                         "equivalent: slots x pages_per_slot + sink)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged pool without the radix prefix index "
                         "(paging only: no cross-request sharing)")
    ap.add_argument("--mesh", default="",
                    help="'data,model' sizes: serve through ShardedBackend "
                         "on a mesh of that shape")
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N engine replicas with the ReplicaRouter")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="bound each replica's waiting deque (0 = unbounded);"
                         " rejections spill across replicas")
    ap.add_argument("--dry-run", action="store_true",
                    help="print resolved shardings for --mesh and exit")
    ap.add_argument("--trace-out", default="",
                    help="record every lifecycle/dispatch edge (serve.trace) "
                         "and export the JSONL event stream here")
    ap.add_argument("--trace-chrome", default="",
                    help="export the trace as chrome://tracing JSON (one "
                         "process per replica, one track per slot)")
    ap.add_argument("--profile-dir", default="",
                    help="bracket the first --profile-dispatches traced "
                         "dispatches with torch.profiler (Chrome trace dir)")
    ap.add_argument("--profile-dispatches", type=int, default=3,
                    help="dispatches inside the --profile-dir bracket")
    ap.add_argument("--telemetry-port", type=int, default=-1,
                    help="serve Prometheus text on 127.0.0.1:PORT/metrics "
                         "during the run (0 = ephemeral port; -1 = off)")
    ap.add_argument("--telemetry-interval", type=float, default=1.0,
                    help="telemetry snapshot cadence, seconds")
    ap.add_argument("--telemetry-jsonl", default="",
                    help="append one JSON metrics snapshot per interval here")
    ap.add_argument("--ledger", action="store_true",
                    help="ineffectual-work ledger (serve.ledger): device-"
                         "resident activation-sparsity / effective-FLOP "
                         "counters drained once per dispatch inside the "
                         "existing token sync (device loop only)")
    ap.add_argument("--ledger-threshold", type=float, default=0.0,
                    help="|x| <= t counts as near-zero in the ledger probes "
                         "(0 = exact zeros only)")
    ap.add_argument("--ledger-group", type=int, default=8,
                    help="ledger per-group zero histogram group size")
    ap.add_argument("--ledger-kblock", type=int, default=32,
                    help="ledger dead-k-block granularity (contraction-dim "
                         "block size an activation-skip kernel would use)")
    ap.add_argument("--quality-every", type=int, default=0,
                    help="shadow-run every Nth full-prefill admission "
                         "through tier 0 and record per-tier logit "
                         "agreement (0 = off; implies --ledger wiring)")
    ap.add_argument("--tiers", default="",
                    help="QoS degradation ladder: 'bits:sparsity[,...]' "
                         "cheapest-last (e.g. '8:0.5,8:0.75') — the registry "
                         "keeps each tier resident and the engine demotes "
                         "the live decode to it under load (serve.qos)")
    ap.add_argument("--qos-demote-depth", type=int, default=8,
                    help="waiting-queue depth that (with hysteresis) demotes "
                         "one tier")
    ap.add_argument("--qos-promote-depth", type=int, default=1,
                    help="queue depth at/below which the engine re-promotes")
    ap.add_argument("--qos-hysteresis", type=int, default=4,
                    help="consecutive steps over/under threshold before a "
                         "tier change")
    ap.add_argument("--qos-page-pressure", type=float, default=0.95,
                    help="page-pool occupancy fraction that also counts as "
                         "overload (paged engines)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request deadline in engine steps (0 = none): "
                         "doomed work is shed at admission, expired work "
                         "cancelled in flight")
    ap.add_argument("--pool-wait-retries", type=int, default=-1,
                    help="bound PoolExhausted requeues per request with "
                         "exponential backoff; past the cap the request is "
                         "shed (-1 = unbounded wait)")
    ap.add_argument("--auto-restart", action="store_true",
                    help="router: rebuild a replica marked dead by a "
                         "ReplicaFault instead of serving degraded")
    ap.add_argument("--processes", type=int, default=1,
                    help="serve through a local fleet of N worker "
                         "processes (launch.fleet + serve.FleetRouter)")
    ap.add_argument("--coordinator", default="",
                    help="HOST:PORT of the torch.distributed process group "
                         "to join")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="fleet size for --coordinator")
    ap.add_argument("--process-id", type=int, default=0,
                    help="this process's index for --coordinator")
    return ap.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """Refuse, before any weights load, what cannot run."""
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process-id {args.process_id} out of range for "
                         f"--num-processes {args.num_processes}")
    if args.num_processes > 1 and not args.coordinator:
        raise SystemExit("--num-processes > 1 needs --coordinator HOST:PORT")
    if args.dry_run and not (args.mesh or args.processes > 1
                             or args.coordinator):
        raise SystemExit("--dry-run needs --mesh data,model")


def _rank_main(rank: int, argv: List[str], world: int, port: int,
               threads: int) -> None:
    """One spawned rank of a `--mesh` run: joins the group as torchrun's
    ranks do (from the environment) and runs the launcher."""
    import os

    import torch
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    main(argv)
    import torch.distributed as dist
    if dist.is_initialized():
        # leave together: rank 0 holds the group's store, and a rank whose
        # peers exited first can abort in the gloo teardown
        dist.barrier()
        dist.destroy_process_group()


def _spawn_ranks(argv: List[str], world: int, device: str) -> None:
    """Run the launcher on `world` ranks, one process each, and wait."""
    import os

    import torch
    import torch.multiprocessing as mp
    if device != "cpu" and world > torch.cuda.device_count():
        raise ValueError(f"--mesh needs {world} cards, "
                         f"{torch.cuda.device_count()} visible")
    threads = max(1, (os.cpu_count() or 1) // world)
    from repro_torch.launch.mesh import free_port
    mp.spawn(_rank_main, args=(list(argv), world, free_port(), threads),
             nprocs=world, join=True)


def _join_group(args: argparse.Namespace) -> bool:
    """Join the process group of torchrun or of --coordinator; False when
    this process runs alone."""
    from repro_torch.launch import mesh as M
    from repro_torch.serve import ensure_distributed
    if M.join_torchrun(args.device):
        return True
    if args.coordinator:
        ensure_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=args.device)
        return True
    return False


def _rank_dispatch_cost(model, cfg: EngineConfig, mesh_shape):
    """One decode dispatch of rank 0 of a (data, model) mesh under the
    port's placement (its slot rows over 'data', its kv heads or Mamba
    channels over 'model'), counted by `analysis.dispatch_cost` on the
    dry-run's fake process group of data x model ranks, in this process
    on the CPU: its collectives issue nothing, so their outputs hold no
    numbers, and only the counts are read."""
    from repro_torch.analysis import dispatch_cost as DC
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.serve.backend import LocalBackend, ShardedBackend

    class RankBackend(ShardedBackend):
        """ShardedBackend on the fake mesh, without `ensure_world` (which
        refuses a fake group to every serving path)."""

        def build(self, model, cfg) -> None:
            self.mesh = self._mesh
            self._member, self._src = True, None
            self._data = SH.axis_group(self.mesh, "data")
            LocalBackend.build(self, model, cfg)

    data, model_n = mesh_shape
    with M.fake_world(data * model_n):
        mesh = M.make_local_mesh(data, model_n, device="meta")
        bk = InferenceEngine(model, dataclasses.replace(
            cfg, device="cpu", ledger=None, trace=None, qos=None),
            backend=RankBackend(mesh)).backend
        return DC.analyze(bk._step_out)


def _dry_run(model, cfg: EngineConfig, mesh_shape) -> None:
    """One PartitionSpec per cache / page / decode-state leaf on an
    abstract (data, model) mesh, and one decode dispatch's FLOPs, bytes,
    wire bytes and collectives per device under the port's placement,
    counted on the dry-run's fake process group (the JAX package's
    line)."""
    import torch

    from repro_torch.analysis import cost
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.serve.paging import PageLayout

    mesh = SH.AbstractMesh(mesh_shape, ("data", "model"))
    print(f"[dry-run] mesh {SH.mesh_axes(mesh)} over {mesh.size} devices")
    cache_len = cfg.max_len + cfg.speculate   # +K speculative write headroom
    caches = T.make_caches(model.cfg, cfg.n_slots, cache_len, device="meta")
    specs = SH.cache_pspecs(caches, mesh, cfg.n_slots, slab=True)
    if not cfg.page_size:
        print(f"[dry-run] KV slab leaves ({cfg.n_slots} slots x "
              f"{cache_len} positions"
              + (f" = max_len + K={cfg.speculate} headroom" if cfg.speculate
                 else "") + "):")
        for li, layer in enumerate(specs):
            for name, spec in layer.items():
                print(f"    {f'[{li}][{name!r}]':48s} {spec}")
    print("[dry-run] decode state vectors:")
    for k, spec in ST.decode_state_pspecs(mesh, cfg.n_slots).items():
        print(f"    {k:48s} {spec}")
    data, model_n = mesh_shape
    # the port's placement: 'data' splits the slab's slots where it
    # divides them (a page store keeps every slot on every data rank),
    # 'model' the kv heads / channels where the specs shard them
    split = not cfg.page_size and cfg.n_slots % data == 0
    rows = cfg.n_slots // data if split else cfg.n_slots
    if cfg.page_size:
        layout = PageLayout(model.cfg, cfg.n_slots, cache_len,
                            cfg.page_size, device="meta")
        n_pages = cfg.n_pages or cfg.n_slots * layout.pp + 1
        pspecs = SH.page_pspecs(caches, layout, mesh, n_pages)
        print(f"[dry-run] page pool: {n_pages} pages x {cfg.page_size} "
              f"positions ({layout.pp}/slot x {cfg.n_slots} slots); "
              "page-store leaves (paged = page-major; resident = "
              "slot-major slab layout):")
        for li, layer in enumerate(pspecs):
            for name, spec in layer.items():
                kind = "paged   " if layout.paged[li][name] else "resident"
                print(f"    {f'[{li}][{name!r}]':40s} {kind} {spec}")
        print(f"    {'page_table':40s} table    "
              f"{SH.P(*(tuple(SH.batch_pspec(mesh, cfg.n_slots)) + (None,)))}")
    r = _rank_dispatch_cost(model, cfg, mesh_shape)
    label = (f"speculative step (K={cfg.speculate}, draft replicated)"
             if cfg.speculate else
             f"paged decode step (K={cfg.decode_chunk}, page="
             f"{cfg.page_size})" if cfg.page_size else
             f"decode step (K={cfg.decode_chunk})")
    coll = {k: int(v["count"]) for k, v in r["collectives"].items()
            if v["count"]}
    print(f"[dry-run] {label}: "
          f"{r['flops']:.3g} flops, {r['bytes']:.3g} B touched, "
          f"{r['wire_bytes']:.3g} B wire, collectives {coll or 'none'}")
    # the port keeps every page on every data rank (ROADMAP.md §3)
    shapes, placed = ((layout.store_shapes(n_pages),
                       [{n: SH.P(None, *sp[1:]) for n, sp in layer.items()}
                        for layer in pspecs]) if cfg.page_size else
                      ([{n: tuple(t.shape) for n, t in layer.items()}
                        for layer in caches], specs))
    itemsize = torch.empty((), dtype=getattr(torch, cfg.cache_dtype)
                           ).element_size()
    cache_bytes = itemsize * sum(
        math.prod(SH.shard_shape(placed[li][n], s, mesh))
        for li, layer in enumerate(shapes) for n, s in layer.items())
    print(f"[dry-run] per device: {rows} of {cfg.n_slots} slot rows, "
          f"{cost.nbytes(model.params):.3g} B of replicated parameters + "
          f"{cache_bytes:.3g} B of its cache shard")


def _dry_run_fleet(args: argparse.Namespace) -> None:
    """The fleet topology, no weights: planned for `--processes N`, live
    (the joined group's) with `--coordinator`."""
    from repro_torch.launch import mesh as M
    data, model_ax = (M.parse_mesh_arg(args.mesh) if args.mesh
                      else (args.replicas, 1))
    if args.coordinator:
        _join_group(args)
        live = M.fleet_topology(data, model_ax, args.replicas,
                                device=args.device)
        print(f"[dry-run] fleet (live): process {live['process_index']} "
              f"of {live['num_processes']}, "
              f"{live['global_device_count']} global devices, "
              f"mesh {data}x{model_ax}, {args.replicas} replicas/process")
        procs = [live]
    else:
        plan = M.plan_fleet_topology(args.processes, data * model_ax,
                                     data, model_ax, args.replicas)
        print(f"[dry-run] fleet (planned): {plan['num_processes']} "
              f"processes x {plan['devices_per_process']} devices = "
              f"{plan['global_device_count']} global, "
              f"mesh {data}x{model_ax}, {args.replicas} replicas/process")
        procs = plan["processes"]
    for p in procs:
        print(f"[dry-run]   process {p['process_index']}: "
              + " ".join(p["local_devices"]))
        for rm in p["replica_meshes"]:
            shape = "x".join(str(v) for v in rm["shape"].values())
            print(f"[dry-run]     replica {rm['replica']} ({shape}): "
                  + " ".join(rm["devices"]))


def _serve_fleet(args: argparse.Namespace) -> None:
    """Local-fleet serving: spawn N workers (launch.fleet), front them with
    the FleetRouter, drive the same Poisson-ish trace. The prompts are drawn
    from the arch's vocab (the coordinator reads its config, never its
    weights)."""
    from repro_torch.launch import fleet as F

    cfg = (C.get_config if args.full else C.get_smoke)(args.arch)
    rng = np.random.default_rng(args.seed)
    with F.spawn_fleet(args.processes, arch=args.arch, n_slots=args.slots,
                       max_len=args.max_len or 96,
                       decode_chunk=args.decode_chunk,
                       replicas_per_process=args.replicas,
                       device=args.device, full=args.full,
                       seed=args.seed) as fl:
        reqs = []
        for _ in range(args.requests):
            s0 = max(1, args.prompt_len + int(rng.integers(-4, 5)))
            prompt = rng.integers(0, cfg.vocab, s0)
            reqs.append(fl.router.submit(
                list(map(int, prompt)), args.gen,
                temperature=args.temperature))
        fl.drive()
        fl.router.stop()
        rep = fl.router.report()
        print(f"[serve] fleet {args.processes} processes: "
              f"{rep['fleet_tokens']:.0f} tokens, "
              f"{rep['fleet_requests_completed']:.0f} done, "
              f"{rep['tokens_per_fleet_step']:.2f} tok/fleet-step, "
              f"failovers {rep['fleet_failovers']:.0f}")
        for r in reqs[:2]:
            print(f"  req{r.rid}: {np.asarray(r.tokens)[:16]} ...")


def main(argv: Optional[List[str]] = None) -> None:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    check_args(args)
    from repro_torch.launch import mesh as M
    mesh_shape = M.parse_mesh_arg(args.mesh) if args.mesh else None
    if args.dry_run and (args.processes > 1 or args.coordinator):
        _dry_run_fleet(args)
        return
    if not args.dry_run:
        if _join_group(args):
            import os
            import torch.distributed as dist
            if dist.get_rank():          # every rank serves; rank 0 prints
                sys.stdout = open(os.devnull, "w")
        elif mesh_shape is not None and mesh_shape[0] * mesh_shape[1] > 1:
            _spawn_ranks(argv, mesh_shape[0] * mesh_shape[1], args.device)
            return
    if args.processes > 1:
        # workers pack their own weights; the coordinator never loads them
        _serve_fleet(args)
        return

    spec = KratosSpec(sparsity=args.sparsity,
                      bits=args.bits or None,
                      act_bits=args.act_bits or None,
                      impl=args.impl, bk=args.block, bn=args.block)
    draft = None
    if args.speculate:
        draft = DraftSpec.from_args(args.draft_bits, args.draft_sparsity,
                                    args.draft_keep_layers)
    tier_specs = parse_tiers(args.tiers) if args.tiers else ()
    registry = ModelRegistry()
    model = registry.load(args.arch, spec, seed=args.seed, draft_spec=draft,
                          tier_specs=tier_specs, smoke=not args.full,
                          device="cpu" if args.dry_run else args.device)
    print(f"[serve] {model.name}: {model.n_packed} packed projections, "
          f"{model.packed_bytes / 1e6:.2f} MB packed vs "
          f"{model.dense_bytes / 1e6:.2f} MB dense "
          f"({model.compression:.2f}x)")
    if tier_specs:
        print(f"[serve] QoS ladder: tier 0 (target) + "
              + ", ".join(f"tier {i + 1} = {t.tag}"
                          for i, t in enumerate(tier_specs)))
    if draft is not None:
        print(f"[serve] self-draft {draft.tag}: {model.draft_packed} packed "
              f"projections, draft/verify flops "
              f"{model.draft_cost_fraction():.2f}, K={args.speculate}")

    max_len = args.max_len or (model.cfg.n_img_tokens + args.prompt_len
                               + args.gen + 8)
    tracing = bool(args.trace_out or args.trace_chrome or args.profile_dir)
    trace_cfg = TraceConfig(
        out=args.trace_out or None, chrome=args.trace_chrome or None,
        profile_dir=args.profile_dir or None,
        profile_dispatches=args.profile_dispatches) if tracing else None
    ledger_cfg = None
    if args.ledger or args.quality_every:
        if args.host_loop:
            raise SystemExit("--ledger requires the device-resident loop "
                             "(drop --host-loop)")
        ledger_cfg = LedgerConfig(threshold=args.ledger_threshold,
                                  group=args.ledger_group,
                                  k_block=args.ledger_kblock,
                                  quality_every=args.quality_every)
    qos = QoSConfig(demote_depth=args.qos_demote_depth,
                    promote_depth=args.qos_promote_depth,
                    hysteresis=args.qos_hysteresis,
                    page_pressure=args.qos_page_pressure) \
        if tier_specs else None
    cfg = EngineConfig(n_slots=args.slots, max_len=max_len, seed=args.seed,
                       device=args.device,
                       device_loop=not args.host_loop,
                       decode_chunk=args.decode_chunk,
                       speculate=args.speculate,
                       max_waiting=args.max_waiting or None,
                       page_size=args.page_size or None,
                       n_pages=args.n_pages or None,
                       prefix_cache=not args.no_prefix_cache,
                       pool_wait_retries=args.pool_wait_retries
                       if args.pool_wait_retries >= 0 else None,
                       qos=qos, trace=trace_cfg, ledger=ledger_cfg)
    if args.dry_run:
        _dry_run(model, cfg, mesh_shape)
        return

    def backend_for(i: int):
        if mesh_shape is None:
            return LocalBackend()
        if args.replicas > 1:
            return ShardedBackend(mesh=backend_for.meshes[i])
        return ShardedBackend(mesh_shape=mesh_shape)

    if mesh_shape is not None and args.replicas > 1:
        backend_for.meshes = M.replica_meshes(*mesh_shape, args.replicas,
                                              device=args.device)

    rng = np.random.default_rng(args.seed)

    def trace():
        for i in range(args.requests):
            s0 = max(1, args.prompt_len + int(rng.integers(-4, 5)))
            yield rng.integers(0, model.cfg.vocab, s0), args.gen, i

    def telemetry_for(sample_fn):
        if args.telemetry_port < 0 and not args.telemetry_jsonl:
            return None
        exp = TelemetryExporter(sample_fn, TelemetryConfig(
            interval=args.telemetry_interval,
            port=args.telemetry_port if args.telemetry_port >= 0 else None,
            jsonl=args.telemetry_jsonl or None))
        exp.start()
        if exp.port is not None:
            print(f"[serve] telemetry: http://127.0.0.1:{exp.port}/metrics")
        return exp

    if args.replicas > 1:
        router = ReplicaRouter.build(
            model, cfg, args.replicas,
            backend_factory=backend_for,
            scheduler_factory=(lambda i: StaticScheduler()) if args.static
            else None,
            auto_restart=args.auto_restart)
        telemetry = telemetry_for(lambda: router_sample(router))
        reqs = [router.submit(p, g, arrival_step=at,
                              temperature=args.temperature,
                              deadline_steps=args.deadline_steps or None)
                for p, g, at in trace()]
        router.run()
        if telemetry is not None:
            telemetry.stop()
        tracers = router.tracers
        print(f"[serve] router {router.format_report()}")
    else:
        engine = InferenceEngine(
            model, cfg, scheduler=StaticScheduler() if args.static else None,
            backend=backend_for(0))
        telemetry = telemetry_for(lambda: engine_sample(engine))
        reqs = []
        for p, g, at in trace():
            # bounded deque + upfront trace submission: back off like a
            # client would — step the engine until the submit is accepted
            while True:
                try:
                    reqs.append(engine.submit(
                        p, g, arrival_step=at,
                        temperature=args.temperature,
                        deadline_steps=args.deadline_steps or None))
                    break
                except EngineSaturated:
                    engine.step()
        engine.run()
        if telemetry is not None:
            telemetry.stop()
        tracers = [engine.trace] if engine.trace.enabled else []
        print(f"[serve] scheduler={engine.scheduler.name} "
              f"backend={engine.backend.name} "
              f"{engine.metrics.format_report()}")
    if tracers:
        if args.trace_out:
            n = export_jsonl(tracers, args.trace_out)
            print(f"[serve] trace: {n} events -> {args.trace_out}")
        if args.trace_chrome:
            n = export_chrome(tracers, args.trace_chrome)
            print(f"[serve] chrome trace: {n} events -> {args.trace_chrome} "
                  f"(open in chrome://tracing or ui.perfetto.dev)")
        if args.profile_dir:
            print(f"[serve] profiler capture (first "
                  f"{args.profile_dispatches} dispatches) -> "
                  f"{args.profile_dir}")
    for r in reqs[:2]:
        print(f"  req{r.id}: {np.asarray(r.generated)[:16]} ...")


if __name__ == "__main__":
    main()

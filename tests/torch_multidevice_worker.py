"""The ranks of `test_torch_multidevice.py`: one gloo process group of four
CPU ranks runs every multi-device scenario of the port once, and rank 0
pickles the results (each a plain value, or the error it raised) for the
tests to assert on. Imports torch and the port only (no JAX). Not a test
module itself.

Weights come from `<workdir>/<arch>/arrays.npz`, the JAX package's
`save_pytree` of its smoke init, which the parent writes and carries into
the port with `checkpoint.convert`, so the parent's single-device JAX
tokens are on the same weights.
"""

import datetime
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
DANUBE, FALCON, MINICPM = "h2o-danube-1.8b", "falcon-mamba-7b", "minicpm3_4b"
NEMOTRON, JAMBA = "nemotron-4-340b", "jamba-v0.1-52b"
IDENTITY_ARCHS = (DANUBE, FALCON, MINICPM)
PAGED_ARCHS = (NEMOTRON, JAMBA, MINICPM)
WEIGHT_ARCHS = (DANUBE, FALCON, MINICPM, NEMOTRON, JAMBA)
JOBS = ((5, 6), (9, 4), (7, 5))
PAGED_CFG = dict(n_slots=4, max_len=32, decode_chunk=2, page_size=8,
                 n_pages=24)


def jobs(vocab, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0), gen) for s0, gen in JOBS]


def prefix_jobs(vocab, seed=5):
    """Prompts that share a 16-token prefix (two full pages of 8)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 16)
    return [(np.concatenate([head, rng.integers(0, vocab, n)]), 4)
            for n in (3, 5, 2)]


def pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32)
    x = rng.standard_normal((8, 2, 16)).astype(np.float32)
    return ws, x


def psum_input(rank):
    return np.random.default_rng(100 + rank).standard_normal(
        (32, 32)).astype(np.float32)


def remesh_tree(params):
    return {"w": torch.arange(64.0).reshape(8, 8), "p": params}


# --------------------------------------------------------------- scenarios

def _model(ctx, arch, **kw):
    from repro_torch.checkpoint import convert as CV
    from repro_torch.serve import ModelRegistry
    from repro_torch import configs as C
    cfg = C.get_smoke(arch)
    params = CV.convert(os.path.join(ctx["workdir"], arch), cfg.n_layers)
    return ModelRegistry().load(arch, params=params, device="cpu", **kw)


def _run(m, backend=None, js=None, **cfg_kw):
    from repro_torch.serve import EngineConfig, InferenceEngine
    cfg = dict(n_slots=4, max_len=32)
    cfg.update(cfg_kw)
    eng = InferenceEngine(m, EngineConfig(device="cpu", **cfg),
                          backend=backend)
    js = jobs(m.cfg.vocab) if js is None else js
    rs = [eng.submit(p, g, arrival_step=i) for i, (p, g) in enumerate(js)]
    eng.run()
    return [list(map(int, r.generated)) for r in rs], eng


def identity(ctx):
    from repro_torch.serve import ShardedBackend
    out = {}
    for arch in IDENTITY_ARCHS:
        m = _model(ctx, arch)
        local, _ = _run(m)
        k1, eng = _run(m, ShardedBackend(mesh_shape=(2, 2)), decode_chunk=1)
        k3, _ = _run(m, ShardedBackend(mesh_shape=(2, 2)), decode_chunk=3)
        out[arch] = {"local": local, "k1": k1, "k3": k3,
                     "describe": eng.backend.describe()}
    return out


def sampled(ctx):
    """Sampled decode: the noise of every slot is drawn on every rank, so
    the sharded tokens are the local ones."""
    from repro_torch.serve import (EngineConfig, InferenceEngine,
                                   ShardedBackend)
    m = _model(ctx, DANUBE)
    outs = []
    for backend in (None, ShardedBackend(mesh_shape=(2, 2))):
        eng = InferenceEngine(m, EngineConfig(n_slots=4, max_len=32,
                                              decode_chunk=2, seed=3,
                                              device="cpu"),
                              backend=backend)
        rs = [eng.submit(p, g, temperature=0.9)
              for p, g in jobs(m.cfg.vocab)]
        eng.run()
        outs.append([list(map(int, r.generated)) for r in rs])
    return {"local": outs[0], "sharded": outs[1]}


def placement(ctx):
    from repro_torch.serve import ShardedBackend
    m = _model(ctx, DANUBE)
    out = {}
    for n in (4, 3):
        _, eng = _run(m, ShardedBackend(mesh_shape=(2, 2)), n_slots=n)
        out[n] = {"k": tuple(eng.pool.caches[0]["k"].shape),
                  "tokens": tuple(eng.backend.state["tokens"].shape),
                  "rows": eng.pool.rows}
    return _gather(out)


def paged(ctx):
    from repro_torch.serve import ShardedBackend
    out = {}
    keys = ("prefix_hit_rate", "prefill_tokens_skipped", "page_occupancy",
            "pages_in_use", "tokens_generated", "decode_steps",
            "micro_steps")
    for arch in PAGED_ARCHS:
        m = _model(ctx, arch)
        local, leng = _run(m, **PAGED_CFG)
        sh, eng = _run(m, ShardedBackend(mesh_shape=(2, 2)), **PAGED_CFG)
        store = eng.pool.store
        li, name = next((i, n) for i, layer in enumerate(store)
                        for n in layer if eng.pool.layout.paged[i][n])
        rep, lrep = eng.metrics.report(), leng.metrics.report()
        out[arch] = {"local": local, "sharded": sh,
                     "store_leaf": tuple(store[li][name].shape),
                     "full_leaf": eng.pool.layout.store_shapes(
                         eng.pool.n_pages)[li][name],
                     "report": {k: rep.get(k) for k in keys},
                     "local_report": {k: lrep.get(k) for k in keys}}
    # prefix reuse through the sharded suffix prefill
    m = _model(ctx, NEMOTRON)
    js = prefix_jobs(m.cfg.vocab)
    cfg = dict(PAGED_CFG, n_pages=32)
    local, leng = _run(m, js=js, **cfg)
    sh, eng = _run(m, ShardedBackend(mesh_shape=(2, 2)), js=js, **cfg)
    out["prefix"] = {"local": local, "sharded": sh,
                     "skipped": eng.metrics.report()["prefill_tokens_skipped"],
                     "local_skipped":
                         leng.metrics.report()["prefill_tokens_skipped"]}
    return _gather(out)


def speculative(ctx):
    from repro_torch.serve import DraftSpec, ShardedBackend
    m = _model(ctx, NEMOTRON, draft_spec=DraftSpec(bits=8))
    plain, _ = _run(m)
    out = {"plain": plain}
    for k in (1, 2):
        out[k], eng = _run(m, ShardedBackend(mesh_shape=(2, 2)), speculate=k)
    out["draft_slab"] = tuple(eng.backend.draft_pool.caches[0]["k"].shape)
    return _gather(out)


def tiers(ctx):
    from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                                   QoSConfig, ShardedBackend)
    m = _model(ctx, DANUBE, tier_specs=(DraftSpec.from_args(8, 0.5, 0),))
    rng = np.random.default_rng(2)
    js = [(rng.integers(0, m.cfg.vocab, 6), 6) for _ in range(6)]
    eng = InferenceEngine(
        m, EngineConfig(n_slots=2, max_len=32, device="cpu",
                        qos=QoSConfig(demote_depth=2, promote_depth=0,
                                      hysteresis=1)),
        backend=ShardedBackend(mesh_shape=(2, 2)))
    reqs = [eng.submit(p, g) for p, g in js]
    eng.run()
    out = {"all_done": all(r.state == "done" and len(r.generated) == 6
                           for r in reqs),
           "demotions": eng.metrics.tier_demotions, "tier": eng.tier,
           "n_free": eng.pool.n_free}
    eng2 = InferenceEngine(m, EngineConfig(n_slots=2, max_len=32,
                                           device="cpu"),
                           backend=ShardedBackend(mesh_shape=(2, 2)))
    keep = eng2.submit(js[0][0], 6)
    victim = eng2.submit(js[1][0], 6)
    doomed = eng2.submit(js[2][0], 10, deadline_steps=2)
    out["doomed"] = (doomed.state, doomed.shed_reason)
    for _ in range(2):
        eng2.step()
    eng2.cancel(victim)
    out["victim"] = (victim.state, victim.shed_reason)
    eng2.run()
    out["keep"] = (keep.state, list(map(int, keep.generated)))
    out["pool"] = (eng2.pool.n_active, eng2.pool.n_free)
    local, _ = _run(_model(ctx, DANUBE), js=[(js[0][0], 6)], n_slots=2)
    out["local_keep"] = local[0]
    return out


def in_place(ctx):
    from repro_torch.serve import (EngineConfig, InferenceEngine,
                                   ShardedBackend)
    m = _model(ctx, DANUBE)
    eng = InferenceEngine(m, EngineConfig(n_slots=4, max_len=32,
                                          decode_chunk=2, device="cpu"),
                          backend=ShardedBackend(mesh_shape=(2, 2)))
    for p, g in jobs(m.cfg.vocab):
        eng.submit(p, g)
    eng.step()

    def ptrs():
        bk = eng.backend
        return ([t.data_ptr() for layer in bk.pool.caches
                 for t in layer.values()]
                + [t.data_ptr() for t in bk.state.values()
                   if isinstance(t, torch.Tensor)])
    before = ptrs()
    before_k = eng.backend.pool.caches[0]["k"].clone()
    eng.backend.decode_block()
    return {"same_ptrs": ptrs() == before,
            "written": not torch.equal(before_k,
                                       eng.backend.pool.caches[0]["k"])}


def router(ctx):
    from repro_torch.launch import mesh as M
    from repro_torch.serve import EngineConfig, ReplicaRouter, ShardedBackend
    meshes = M.replica_meshes(2, 2, 2, device="cpu")
    ranks = [sorted(mm.mesh.reshape(-1).tolist()) for mm in meshes]
    m = _model(ctx, DANUBE)
    cfg = EngineConfig(n_slots=2, max_len=32, decode_chunk=2, max_waiting=2,
                       device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.cfg.vocab, 6) for _ in range(6)]
    toks = []
    for factory in (None, lambda i: ShardedBackend(mesh=meshes[i])):
        r = ReplicaRouter.build(m, cfg, 2, backend_factory=factory)
        reqs = [r.submit(p, 5, arrival_step=0) for p in prompts]
        r.run()
        toks.append([list(map(int, q.generated)) for q in reqs])
    rep = r.report()
    return {"ranks": ranks, "local": toks[0], "sharded": toks[1],
            "completed": rep["requests_completed"],
            "names": sorted({e.backend.name for e in r.replicas}),
            "describe": [e.backend.describe() for e in r.replicas]}


def distributed(ctx):
    from repro_torch.serve import DistributedBackend, ensure_distributed
    # a second call with this process's identity is a no-op
    ensure_distributed(f"127.0.0.1:{ctx['port']}", WORLD, ctx["rank"],
                       device="cpu")
    m = _model(ctx, DANUBE)
    local, _ = _run(m)
    toks, eng = _run(m, DistributedBackend(mesh_shape=(2, 2), device="cpu"))
    return _gather({"local": local, "dist": toks,
                    "describe": eng.backend.describe()})


def pipeline(ctx):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_reference)
    mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("pod",))
    ws, x = (torch.from_numpy(a) for a in pipeline_inputs())

    def fn(w, h):
        return torch.tanh(h @ w)
    got = pipeline_apply(ws, x, fn, mesh, axis="pod")
    want = pipeline_reference(ws, x, fn)
    wg = ws.clone().requires_grad_(True)
    (pipeline_apply(wg, x, fn, mesh, axis="pod") ** 2).sum().backward()
    grad = wg.grad.clone()
    dist.all_reduce(grad)                 # rank s holds stage s's row
    wr = ws.clone().requires_grad_(True)
    (pipeline_reference(wr, x, fn) ** 2).sum().backward()
    return _gather({"got": got.detach().numpy(), "want": want.numpy(),
                    "grad": grad.numpy(), "grad_ref": wr.grad.numpy()})


def psum_int8(ctx):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.compression import cross_pod_psum_int8
    mesh = DeviceMesh("cpu", torch.arange(WORLD), mesh_dim_names=("pod",))
    x = torch.from_numpy(psum_input(ctx["rank"]))
    return _gather(cross_pod_psum_int8(x, mesh, axis="pod").numpy())


def remesh(ctx):
    from repro_torch.checkpoint import convert as CV
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch import configs as C
    cfg = C.get_smoke(DANUBE)
    params = CV.convert(os.path.join(ctx["workdir"], DANUBE), cfg.n_layers)
    tree = remesh_tree(params)
    mesh_a = M.make_local_mesh(4, 1, device="cpu")
    mesh_b = M.make_local_mesh(2, 2, device="cpu")

    def placed(mesh, w_spec):
        sh = {"w": SH.NamedSharding(mesh, w_spec)}
        sh.update({"p/" + k: v for k, v in
                   SH.param_shardings(mesh, params).items()})
        return sh
    from repro_torch import tree as tu
    sh_a = placed(mesh_a, SH.P("data", None))
    flat = tu.flatten_with_paths(tree)
    sharded = tu.unflatten(tree, [
        sh_a[k].distribute(sh_a[k].shard(v).contiguous(), v.shape)
        for k, v in flat.items()])
    d = os.path.join(ctx["workdir"], "remesh")
    mgr = CheckpointManager(d)
    mgr.save(1, sharded)
    sh_b = placed(mesh_b, SH.P("data", "model"))
    restored, step = mgr.restore(tree, shardings=sh_b)
    rflat = tu.flatten_with_paths(restored)
    local_ok = all(torch.equal(rflat[k].to_local(), sh_b[k].shard(v))
                   for k, v in flat.items())
    whole_ok = all(torch.equal(rflat[k].full_tensor(), v)
                   for k, v in flat.items())
    sharded_b = sum(1 for k in flat if any(e is not None
                                           for e in sh_b[k].spec))
    return _gather({"step": step, "local_ok": local_ok,
                    "whole_ok": whole_ok, "n_sharded": sharded_b,
                    "dir": d})


def training(ctx):
    from repro_torch import configs as C
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    from repro_torch.optim import adamw as O
    from repro_torch.train import (SimulatedFailure, TrainLoopConfig,
                                   run_training)
    cfg = C.get_smoke(DANUBE)
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    data = DataConfig(vocab=cfg.vocab, batch=8, seq=16, seed=5)

    def loop(**kw):
        return TrainLoopConfig(**dict(dict(steps=4, log_every=0), **kw))
    single = run_training(cfg, opt, data, loop(), device="cpu")
    mesh = M.make_local_mesh(2, 2, device="cpu")
    ck = os.path.join(ctx["workdir"], "train_ck")
    with SH.use_mesh(mesh):
        sharded = run_training(cfg, opt, data, loop(), device="cpu")
        try:
            run_training(cfg, opt, data, loop(ckpt_dir=ck, ckpt_every=2,
                                               fail_at_step=3),
                         device="cpu")
            failed = False
        except SimulatedFailure:
            failed = True
        resumed = run_training(
            cfg, opt, data, loop(ckpt_dir=ck, ckpt_every=2), device="cpu",
            state_shardings=SH.NamedSharding(mesh, SH.P()))
    loss = lambda out: [h["loss"] for h in out["history"]]
    return _gather({"single": loss(single), "sharded": loss(sharded),
                    "failed": failed, "resumed_from": resumed["resumed_from"],
                    "resumed": loss(resumed)})


SCENARIOS = (identity, sampled, placement, paged, speculative, tiers,
             in_place, router, distributed, pipeline, psum_int8, remesh,
             training)


def _gather(value):
    """Every rank's value, in rank order (collective)."""
    out = [None] * WORLD
    dist.all_gather_object(out, value)
    return out


def rank_main(rank, port, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    ctx = {"rank": rank, "port": port, "workdir": workdir}
    results = {}
    for fn in SCENARIOS:
        try:
            results[fn.__name__] = fn(ctx)
        except Exception:                  # noqa: BLE001 (reported)
            results[fn.__name__] = {"error": traceback.format_exc()}
        dist.barrier()
    if rank == 0:
        with open(os.path.join(workdir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


def spawn(workdir, meanwhile=None):
    """Run every scenario on WORLD gloo ranks, calling `meanwhile()` here
    while they run; returns (rank 0's results, meanwhile's value)."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port
    port = free_port()
    ctx = mp.start_processes(rank_main, args=(port, workdir), nprocs=WORLD,
                             join=False, start_method="spawn")
    value = meanwhile() if meanwhile is not None else None
    while not ctx.join():
        pass
    with open(os.path.join(workdir, "results.pkl"), "rb") as f:
        return pickle.load(f), value


if __name__ == "__main__":
    print(spawn(tempfile.mkdtemp())[0])

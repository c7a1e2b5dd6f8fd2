"""Port parity, the serving surface: `SchedulerBase` / `ContinuousScheduler`
/ `StaticScheduler` (the cases of `tests/test_serve.py`), the engine's
`scheduler=` / `metrics=` / `backend=` arguments and `n_active`,
`ExecutionBackend` and `describe()`, `ReplicaRouter.build(
scheduler_factory=, backend_factory=)` through a crash and its
auto_restart, each against the JAX package on the same carried weights
and traffic, and `repro_torch.serve.__all__` against `repro.serve.__all__`
(every name the port lacks mapped to the ROADMAP.md item that ports it),
as `repro.train.__all__` and the public names of `repro.optim`,
`repro.data`, `repro.checkpoint`, their modules and
`repro.distributed.compression` against the port's, and the paper
benchmarks' modules (`repro.core.conv`, `repro.core.bench_specs`,
`repro.analysis.roofline`, `repro.launch.mesh`) the same way, every
module or name the port lacks or refuses mapped to its item; and the
field order of the dataclasses both packages share."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

from torch_serve_parity import DANUBE, J, P, models, needs_jax
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

# names of `repro.serve` the port does not export yet -> ROADMAP.md item
UNPORTED = {}


def _reqs(n):
    return [P.Request(id=i, prompt=np.zeros(4, np.int32), max_new_tokens=4)
            for i in range(n)]


def test_continuous_scheduler_fills_free_slots():
    s = P.ContinuousScheduler(max_prefills_per_step=2)
    waiting = _reqs(5)
    assert s.admissible(waiting, n_active=1, n_free=3) == waiting[:2]
    assert s.admissible(waiting, n_active=4, n_free=0) == []
    assert s.name == "continuous"
    assert P.ContinuousScheduler().max_prefills_per_step == 1


def test_static_scheduler_drains_before_refill():
    s = P.StaticScheduler()
    waiting = _reqs(5)
    assert s.admissible(waiting, n_active=2, n_free=2) == []
    assert s.admissible(waiting, n_active=0, n_free=4) == waiting[:4]
    assert s.name == "static"
    assert isinstance(s, P.scheduler.SchedulerBase)
    with pytest.raises(NotImplementedError):
        P.scheduler.SchedulerBase().admissible(waiting, 0, 4)


def _traffic(vocab, n=5, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, 4 + i), 3 + (i % 3)) for i in range(n)]


def _serve(pkg, m, traffic, **kw):
    """Serve through an engine made with `kw`'s scheduler / metrics /
    backend; returns (tokens, n_active after each step, engine)."""
    cfg = dict(n_slots=2, max_len=24, decode_chunk=2)
    if pkg is P:
        cfg["device"] = "cpu"
    eng = pkg.InferenceEngine(m, pkg.EngineConfig(**cfg), **kw)
    reqs = [eng.submit(p, g) for p, g in traffic]
    active = []
    while eng.n_waiting or eng.pool.n_active:
        eng.step()
        active.append(eng.n_active)
    return [list(r.generated) for r in reqs], active, eng


@needs_jax
@pytest.mark.parametrize("policy", ["StaticScheduler", "ContinuousScheduler"])
def test_engine_scheduler_matches_jax(policy):
    """An engine under an injected scheduler gives the JAX engine's greedy
    tokens, `n_active` after every step and step-clock report; static
    admits a whole wave only once every slot has drained."""
    jm, pm = models(DANUBE)
    traffic = _traffic(pm.cfg.vocab)
    want, want_active, jeng = _serve(J, jm, traffic,
                                     scheduler=getattr(J, policy)())
    got, active, eng = _serve(P, pm, traffic,
                              scheduler=getattr(P, policy)())
    assert got == want and active == want_active
    assert eng.scheduler.name == jeng.scheduler.name
    for k in ("decode_steps", "micro_steps", "mean_occupancy",
              "latency_steps_p99", "ttft_steps_p99"):
        assert eng.metrics.report()[k] == jeng.metrics.report()[k], k
    if policy == "StaticScheduler":
        # one wave of 2, drained to 0 active before the next wave
        assert 0 in active[:-1]


def test_injected_metrics_and_backend_are_used():
    """`metrics=` and `backend=` are the engine's own: the backend is
    built on the engine's config and owns its pool; the sink counts the
    run."""
    _, pm = models(DANUBE)

    class Backend(P.LocalBackend):
        name = "probe"

    metrics, backend = P.ServeMetrics(), Backend()
    toks, _, eng = _serve(P, pm, _traffic(pm.cfg.vocab, n=2),
                          metrics=metrics, backend=backend)
    assert eng.metrics is metrics and eng.backend is backend
    assert eng.pool is backend.pool and backend.cfg is eng.cfg
    assert metrics.report()["tokens_generated"] == sum(map(len, toks)) > 0
    assert backend.describe() == {"backend": "probe", "mesh_shape": [1, 1]}


@needs_jax
def test_execution_backend_base_and_describe():
    """`ExecutionBackend` is the abstract base (build raises, name
    "base"); `LocalBackend.describe()` equals the JAX backend's."""
    assert issubclass(P.LocalBackend, P.ExecutionBackend)
    base = P.ExecutionBackend()
    assert base.name == "base"
    assert base.describe() == {"backend": "base", "mesh_shape": [1, 1]}
    with pytest.raises(NotImplementedError):
        base.build(None, None)
    jm, pm = models(DANUBE)
    with pytest.raises(NotImplementedError):
        P.InferenceEngine(pm, P.EngineConfig(device="cpu"),
                          backend=P.ExecutionBackend())
    jeng = J.InferenceEngine(jm, J.EngineConfig(n_slots=2, max_len=24))
    eng = P.InferenceEngine(pm, P.EngineConfig(n_slots=2, max_len=24,
                                               device="cpu"))
    assert eng.backend.describe() == jeng.backend.describe()
    assert eng.backend.name == "local"


def _factory_router(pkg, m, traffic, calls):
    """A 2-replica router built with both factories (each call recorded)
    through a crash of replica 0 at step 3 with auto_restart."""
    kw = dict(n_slots=2, max_len=24, decode_chunk=2)
    if pkg is P:
        kw["device"] = "cpu"

    class Backend(pkg.LocalBackend):
        name = "factory"

    def backend_factory(i):
        calls.append(("backend", i))
        return Backend()

    def scheduler_factory(i):
        calls.append(("scheduler", i))
        return pkg.StaticScheduler()

    router = pkg.ReplicaRouter.build(
        m, pkg.EngineConfig(**kw), 2, backend_factory=backend_factory,
        scheduler_factory=scheduler_factory, auto_restart=True)
    reqs = [router.submit(p, g) for p, g in traffic]
    pkg.ChaosHarness(router, [pkg.Fault(kind="crash", step=3,
                                        replica=0)]).run()
    return router, reqs


@needs_jax
def test_router_build_factories_through_auto_restart():
    """`ReplicaRouter.build(backend_factory=, scheduler_factory=)`: every
    replica, the restarted one included, is built from the factories
    (the same calls as JAX's), and the run's tokens and restart count
    equal JAX's router under the same crash."""
    jm, pm = models(DANUBE)
    traffic = _traffic(pm.cfg.vocab, n=6)
    jcalls, calls = [], []
    jrouter, jreqs = _factory_router(J, jm, traffic, jcalls)
    router, reqs = _factory_router(P, pm, traffic, calls)
    assert calls == jcalls and calls[-2:] in (
        [("scheduler", 0), ("backend", 0)], [("backend", 0), ("scheduler", 0)])
    assert router.restarts == jrouter.restarts == 1
    assert [list(r.generated) for r in reqs] \
        == [list(r.generated) for r in jreqs]
    for eng in router.replicas:
        assert eng.scheduler.name == "static"
        assert eng.backend.name == "factory"


@needs_jax
def test_serve_exports_cover_the_reference():
    """Every name `repro.serve` exports is exported by `repro_torch.serve`,
    apart from the listed unported ones, each mapped to its ROADMAP.md
    item; the port exports no name the list calls unported."""
    missing = set(J.__all__) - set(P.__all__)
    assert missing == set(UNPORTED), sorted(missing ^ set(UNPORTED))
    assert all(item.startswith("item ") for item in UNPORTED.values())
    for name in P.__all__:
        assert hasattr(P, name), name


# public names of the training packages the port does not have yet
UNPORTED_TRAIN = {}
TRAIN_MODULES = ("repro.optim", "repro.data", "repro.checkpoint",
                 "repro.train", "repro.optim.adamw", "repro.data.pipeline",
                 "repro.checkpoint.manager", "repro.train.loop",
                 "repro.distributed.compression",
                 "repro.distributed.sharding", "repro.distributed.pipeline")


def _public(name):
    """A package's exported names; a module's own functions, classes and
    dataclasses (not what it imports)."""
    mod = importlib.import_module(name)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and (hasattr(mod, "__path__")
                 or getattr(v, "__module__", None) == name)}


@needs_jax
@pytest.mark.parametrize("name", TRAIN_MODULES)
def test_train_exports_cover_the_reference(name):
    """Every public name of the JAX package's training modules exists in
    the port's module of the same path (`repro.train.__all__` equal),
    apart from the listed unported ones, each mapped to its ROADMAP.md
    item."""
    port = "repro_torch" + name[len("repro"):]
    missing = {f"{name}.{n}" for n in _public(name) - _public(port)}
    assert missing == {k for k in UNPORTED_TRAIN
                       if k.startswith(name + ".")}, sorted(missing)
    if name == "repro.train":
        assert importlib.import_module(port).__all__ == \
            importlib.import_module(name).__all__
    for n in _public(port):
        assert hasattr(importlib.import_module(port), n), n


# the paper benchmarks' modules, covered name for name
BENCH_MODULES = ("repro.core.conv", "repro.core.bench_specs", "repro.analysis",
                 "repro.analysis.roofline", "repro.launch.mesh")
# modules of the JAX package the port has no counterpart of -> ROADMAP.md
# item (`repro_torch.analysis.cost` stands in for the HLO analysis in the
# figures; the dry-run reads it)
UNPORTED_BENCH_MODULES = {
    "repro.analysis.hlo": "item 14 (the dry-run): its XLA HLO analysis",
    "repro.launch.dryrun": "item 14 (the dry-run)",
    "repro.launch.dryrun_all": "item 14 (the dry-run)",
    "repro.launch.shapes": "item 14 (the dry-run)"}
# names the port has that refuse with NotImplementedError naming the item
REFUSED_BENCH = {}


@needs_jax
@pytest.mark.parametrize("name", BENCH_MODULES)
def test_bench_exports_cover_the_reference(name):
    """Every public name of the JAX package's benchmark modules exists in
    the port's module of the same path; the listed ones refuse, naming
    their ROADMAP.md item. The mesh module's pure functions return the
    JAX package's values."""
    port = "repro_torch" + name[len("repro"):]
    assert _public(name) - _public(port) == set()
    mod = importlib.import_module(port)
    for full, item in REFUSED_BENCH.items():
        if full.rsplit(".", 1)[0] != name:
            continue
        fn = getattr(mod, full.rsplit(".", 1)[1])
        required = [p for p in inspect.signature(fn).parameters.values()
                    if p.default is p.empty and p.kind in
                    (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        with pytest.raises(NotImplementedError, match=item):
            fn(*[1] * len(required))
    if name == "repro.launch.mesh":
        ref = importlib.import_module(name)
        for arg in ("2,4", "data=2,model=4", "model=3,data=1"):
            assert mod.parse_mesh_arg(arg) == ref.parse_mesh_arg(arg)
        assert mod.plan_fleet_topology(2, 4, 2, 2, 2) == \
            ref.plan_fleet_topology(2, 4, 2, 2, 2)


@needs_jax
@pytest.mark.parametrize("name", sorted(UNPORTED_BENCH_MODULES))
def test_unported_bench_modules_name_their_item(name):
    import importlib.util
    assert importlib.util.find_spec(name) is not None
    assert importlib.util.find_spec("repro_torch" + name[len("repro"):]) \
        is None
    assert UNPORTED_BENCH_MODULES[name].startswith("item ")


# the dataclasses both packages define; the port's `device` stands in the
# reference's `backend` slot
SHARED_DATACLASSES = {
    "serve.scheduler.Request": {},
    "serve.engine.EngineConfig": {"backend": "device"},
    "models.transformer.ModelConfig": {}}


@needs_jax
@pytest.mark.parametrize("name", sorted(SHARED_DATACLASSES))
def test_shared_dataclasses_order_fields_as_the_reference(name):
    """`dataclasses.fields` gives the JAX package's order, so positional
    construction binds the same fields in both."""
    mod, cls = name.rsplit(".", 1)
    ref = getattr(importlib.import_module("repro." + mod), cls)
    port = getattr(importlib.import_module("repro_torch." + mod), cls)
    rename = SHARED_DATACLASSES[name]
    assert [rename.get(f.name, f.name) for f in dataclasses.fields(ref)] \
        == [f.name for f in dataclasses.fields(port)]

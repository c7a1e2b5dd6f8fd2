"""Port parity, the chaos harness (`repro_torch.serve.chaos`): the cases of
`tests/test_chaos.py` on the port — a replica crash failed over token for
token, with and without `auto_restart`; every replica dead raises; one
NaN-logits sync caught at the sync boundary; a page-pool squeeze delaying
admission then recovering (and refused on a slab); a slow dispatch
changing wall time only — each crash and storm outcome held to JAX's
harness under the same schedule, and a seeded storm's outcome (completed,
shed, deaths, restarts, tokens) equal to JAX's under the same seed. The
`cuda` test checks that a restart frees the dead replica's cache and
graphs."""

import gc

import numpy as np
import pytest

from torch_serve_parity import (DANUBE, NEMOTRON, J, P, assert_pristine,
                                models, needs_jax, torch)
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)


def _jobs(vocab, n=4, gen=8):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, 6), gen) for _ in range(n)]


def _run_fleet(pkg, m, jobs, faults, n_replicas=2, cfg_kw=None, **router_kw):
    kw = dict(n_slots=2, max_len=48, **(cfg_kw or {}))
    if pkg is P:
        kw["device"] = "cpu"
    router = pkg.ReplicaRouter.build(m, pkg.EngineConfig(**kw), n_replicas,
                                     **router_kw)
    reqs = [router.submit(p, g) for p, g in jobs]
    harness = pkg.ChaosHarness(router, [pkg.Fault(**vars(f))
                                        for f in faults])
    harness.run()
    return router, reqs, harness


def _both(jobs_kw, faults, **kw):
    """The same fleet, traffic and schedule through JAX's harness and the
    port's; returns (JAX, port) triples of (router, requests, harness)."""
    jm, pm = models(DANUBE)
    jobs = _jobs(jm.cfg.vocab, **jobs_kw)
    return (_run_fleet(J, jm, jobs, faults, **kw),
            _run_fleet(P, pm, jobs, faults, **kw))


def _outcome(router, reqs):
    rep = router.report()
    return dict(completed=rep["requests_completed"], shed=rep["shed"],
                deaths=router.replica_deaths, restarts=router.restarts,
                failovers=rep["failovers"], alive=list(router.alive),
                states=[r.state for r in reqs],
                tokens=[list(r.generated) for r in reqs])


# ---------------------------------------------------------------------------
# schedule / Fault plumbing
# ---------------------------------------------------------------------------

def test_fault_validates():
    with pytest.raises(ValueError, match="unknown fault kind"):
        P.Fault(kind="meteor", step=1)
    with pytest.raises(ValueError, match="duration"):
        P.Fault(kind="crash", step=1, duration=0)


@needs_jax
@pytest.mark.parametrize("seed,n_steps,n_replicas,kinds", [
    (7, 60, 3, None), (11, 30, 2, ("crash", "slow_dispatch"))])
def test_seeded_schedule_equals_jax(seed, n_steps, n_replicas, kinds):
    kw = {} if kinds is None else dict(kinds=kinds)
    mine = P.seeded_schedule(seed, n_steps, n_replicas, rate=0.2, **kw)
    theirs = J.seeded_schedule(seed, n_steps, n_replicas, rate=0.2, **kw)
    assert [vars(f) for f in mine] == [vars(f) for f in theirs]
    assert mine == P.seeded_schedule(seed, n_steps, n_replicas, rate=0.2,
                                     **kw)
    assert all(0 <= f.replica < n_replicas and f.step >= 2 for f in mine)


# ---------------------------------------------------------------------------
# crash -> failover
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("auto_restart", [False, True])
def test_crash_fails_over_token_identically(auto_restart):
    """Replica 0 crashes mid-decode: it is marked dead (or replaced), its
    requests resume on a survivor, every request's greedy output equals
    the fault-free run's, and the outcome equals JAX's harness."""
    jobs_kw = dict(n=6) if auto_restart else {}
    crash = [P.Fault(kind="crash", step=3, replica=0)]
    (_, clean, _), _ = _both(jobs_kw, [])
    (jr, jreqs, _), (router, reqs, harness) = _both(
        jobs_kw, crash, auto_restart=auto_restart)
    assert [f.kind for f in harness.injected] == ["crash"]
    assert _outcome(router, reqs) == _outcome(jr, jreqs)
    assert all(r.state == "done" for r in reqs)
    assert [r.generated for r in reqs] == [r.generated for r in clean]
    rep = router.report()
    assert rep["replica_deaths"] == 1.0 and rep["failovers"] >= 1.0
    if auto_restart:
        assert router.alive == [True, True] and router.restarts == 1
        assert rep["requests_completed"] == float(len(reqs))
        assert rep["n_replicas"] == 2.0
        for eng in router.replicas:
            assert_pristine(eng)
    else:
        assert router.alive == [False, True]
        assert router.replicas[1].metrics.failovers >= 1
        assert_pristine(router.replicas[1])


@needs_jax
def test_all_dead_raises_instead_of_hanging():
    m = models(DANUBE)[1]
    with pytest.raises(RuntimeError, match="every replica is dead"):
        _run_fleet(P, m, _jobs(m.cfg.vocab),
                   [P.Fault(kind="crash", step=2, replica=0)], n_replicas=1)


# ---------------------------------------------------------------------------
# nan_logits -> sync validation refuses corrupt tokens
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("cfg_kw,arch", [({}, DANUBE),
                                         (dict(speculate=2), NEMOTRON)])
def test_nan_logits_is_caught_at_the_sync_boundary(cfg_kw, arch):
    """One poisoned sync (plain or speculative): the engine raises
    ReplicaFault before emitting a corrupt token, the router fails the
    replica over, and the outputs equal the clean run's and JAX's."""
    jm, pm = models(arch, draft=bool(cfg_kw))
    jobs = _jobs(jm.cfg.vocab)
    nan = [P.Fault(kind="nan_logits", step=3, replica=0)]
    _, clean, _ = _run_fleet(P, pm, jobs, [], cfg_kw=cfg_kw)
    jr, jreqs, _ = _run_fleet(J, jm, jobs, nan, cfg_kw=cfg_kw)
    router, reqs, _ = _run_fleet(P, pm, jobs, nan, cfg_kw=cfg_kw)
    assert router.alive == [False, True] and router.replica_deaths == 1
    assert _outcome(router, reqs) == _outcome(jr, jreqs)
    assert all(0 <= t < pm.cfg.vocab for r in reqs for t in r.generated)
    assert [r.generated for r in reqs] == [r.generated for r in clean]


@needs_jax
def test_engine_rejects_out_of_vocab_sync_directly():
    m = models(DANUBE)[1]
    eng = P.InferenceEngine(m, P.EngineConfig(n_slots=2, max_len=48,
                                              device="cpu"))
    r = eng.submit(_jobs(m.cfg.vocab, n=1)[0][0], 8)
    eng.step()
    k, b = eng.cfg.decode_chunk, eng.cfg.n_slots
    eng.backend.decode_block = lambda: np.full((k, b), -1, np.int32)
    with pytest.raises(P.ReplicaFault, match="decode sync outside"):
        eng.step()
    assert all(0 <= t < m.cfg.vocab for t in r.generated)


# ---------------------------------------------------------------------------
# pool_squeeze -> admission backpressure, then recovery
# ---------------------------------------------------------------------------

@needs_jax
def test_pool_squeeze_delays_admission_then_recovers():
    """Confiscated free pages make admission wait while resident requests
    keep decoding; at expiry the pages return and the queue drains, nothing
    shed, the pool pristine, and the outcome equals JAX's."""
    out = []
    for pkg, m in zip((J, P), models(NEMOTRON)):
        kw = dict(device="cpu") if pkg is P else {}
        router = pkg.ReplicaRouter.build(m, pkg.EngineConfig(
            n_slots=2, max_len=32, page_size=8, n_pages=9, **kw), 1)
        reqs = [router.submit(np.arange(2, 8) * (i + 3) % 97, 8)
                for i in range(3)]
        pkg.ChaosHarness(router, [pkg.Fault(kind="pool_squeeze", step=2,
                                            duration=4, pages=6)]).run()
        eng = router.replicas[0]
        out.append((_outcome(router, reqs), eng.metrics.pool_waits))
    assert out[1] == out[0]
    assert all(r.state == "done" and len(r.generated) == 8 for r in reqs)
    assert eng.metrics.pool_waits >= 1 and eng.metrics.shed == 0
    assert_pristine(eng)


@needs_jax
def test_pool_squeeze_refuses_slab_pools():
    m = models(DANUBE)[1]
    router = P.ReplicaRouter.build(m, P.EngineConfig(
        n_slots=2, max_len=48, device="cpu"), 1)
    router.submit(_jobs(m.cfg.vocab, n=1)[0][0], 4)
    harness = P.ChaosHarness(router, [P.Fault(kind="pool_squeeze", step=2,
                                              pages=2)])
    with pytest.raises(ValueError, match="paged pool"):
        harness.run()


# ---------------------------------------------------------------------------
# slow_dispatch -> wall degradation only
# ---------------------------------------------------------------------------

@needs_jax
def test_slow_dispatch_degrades_wall_not_tokens():
    """A slowed window changes nothing on the step clock, and the backend's
    own method shows through again at expiry (no shadow left on it)."""
    m = models(DANUBE)[1]
    jobs = _jobs(m.cfg.vocab)
    _, clean, _ = _run_fleet(P, m, jobs, [])
    router, reqs, harness = _run_fleet(
        P, m, jobs, [P.Fault(kind="slow_dispatch", step=2, duration=2,
                             delay_s=0.002)])
    assert router.alive == [True, True]
    assert [r.generated for r in reqs] == [r.generated for r in clean]
    assert harness._active == []
    be = router.replicas[0].backend
    assert "decode_block" not in vars(be)
    assert be.decode_block.__name__ == "decode_block"


# ---------------------------------------------------------------------------
# a seeded storm
# ---------------------------------------------------------------------------

@needs_jax
def test_seeded_storm_matches_jax():
    """A reproducible multi-fault storm with auto_restart (slab replicas:
    no squeeze): every request reaches a terminal state, the aggregate
    accounts for all of them, every pool ends pristine, and the outcome
    (completed, shed, deaths, restarts, tokens) equals JAX's under the
    same seed."""
    faults = [f for f in P.seeded_schedule(11, 30, 2, rate=0.2)
              if f.kind != "pool_squeeze"]
    assert {f.kind for f in faults} >= {"crash", "nan_logits"}
    (jr, jreqs, _), (router, reqs, _) = _both(
        dict(n=6, gen=6), faults, auto_restart=True)
    assert _outcome(router, reqs) == _outcome(jr, jreqs)
    assert all(r.state in ("done", "shed") for r in reqs)
    assert all(len(r.generated) == 6 for r in reqs if r.state == "done")
    rep = router.report()
    assert rep["requests_completed"] + rep["shed"] == float(len(reqs))
    assert router.replica_deaths >= 1
    for eng in router.replicas:
        assert_pristine(eng)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_cuda_restart_frees_the_dead_replica(cuda_device):
    """A crash with auto_restart on the card: the fresh replica's graphs
    serve token-identically to a fault-free fleet, and once the restart is
    done the device holds less than a quarter of a replica more than
    before the crash: the dead replica's cache and graphs are freed."""
    m = P.ModelRegistry().load(NEMOTRON)
    jobs = _jobs(m.cfg.vocab, n=6)
    cfg = P.EngineConfig(n_slots=2, max_len=48, decode_chunk=2)
    # a replica's own bytes, and a built-then-dropped engine leaves none
    # behind (the first build may set up the warm-up stream's workspace)
    for _ in range(2):
        gc.collect()
        base = torch.cuda.memory_allocated()
        one = P.InferenceEngine(m, cfg)
        replica_bytes = torch.cuda.memory_allocated() - base
        del one
        gc.collect()
    assert torch.cuda.memory_allocated() == base
    clean = P.ReplicaRouter.build(m, cfg, 2)
    want = [clean.submit(p, g) for p, g in jobs]
    clean.run()
    del clean
    router = P.ReplicaRouter.build(m, cfg, 2, auto_restart=True)
    reqs = [router.submit(p, g) for p, g in jobs]
    harness = P.ChaosHarness(router, [P.Fault(kind="crash", step=3,
                                              replica=1)])
    while router.step_count < 2:
        harness.step()
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    harness.step()                            # the crash and the restart
    assert router.restarts == 1
    torch.cuda.synchronize()
    gc.collect()
    after = torch.cuda.memory_allocated()
    assert replica_bytes > 0
    assert after - before < replica_bytes / 4, (before, after, replica_bytes)
    harness.run()
    assert [r.generated for r in reqs] == [r.generated for r in want]

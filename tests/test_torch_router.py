"""Port parity, the replica router (`repro_torch.serve.router`): tokens and
the routing counters (spills, overflowed, rebalanced, rejected_fleet)
against JAX's `ReplicaRouter` on the same bounded-deque traffic,
`ServeMetrics.aggregate` against JAX's on its step-clock keys, a
2-replica router's Chrome and JSONL exports against JAX's, and the cases
of `tests/test_router_edges.py` on the port (empty fleet, an all-saturated
fleet parking and draining its overflow, a single-replica rebalance,
`steal_waiting` / `adopt` boundaries, the fleet rejection count)."""

import json

import numpy as np
import pytest

from torch_serve_parity import DANUBE, NEMOTRON, J, P, models, needs_jax
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.serve.trace import chrome_events


# step-clock and count keys of the fleet report: equal to JAX's exactly
STEP_KEYS = ("n_replicas", "requests_completed", "tokens_generated",
             "rejected", "decode_steps", "micro_steps", "idle_steps",
             "host_syncs_decode", "host_syncs_prefill", "tokens_per_step",
             "mean_occupancy", "latency_steps_p50", "latency_steps_p99",
             "ttft_steps_p50", "ttft_steps_p99", "prefix_hit_rate",
             "prefill_tokens_skipped", "pool_waits", "pages_in_use",
             "page_occupancy", "gather_bytes_avoided", "shed", "failovers",
             "router_steps", "tokens_per_router_step", "spills",
             "overflowed", "rebalanced", "rejected_fleet", "replica_deaths",
             "restarts")


def _routers(hold_overflow=True, **cfg_kw):
    """(JAX router, port router) of 2 replicas of the same model and
    config."""
    return [pkg.ReplicaRouter.build(
        m, pkg.EngineConfig(n_slots=1, max_len=32, **cfg_kw, **kw), 2,
        hold_overflow=hold_overflow)
        for pkg, m, kw in zip((J, P), models(DANUBE),
                              ({}, dict(device="cpu")))]


# 8 requests of mixed budgets and arrivals; two router steps run after the
# fourth submit, so later submits meet skewed queues
GENS = [2, 9, 3, 8, 2, 2, 6, 3]
ARRIVALS = [0, 0, 0, 0, 1, 1, 5, 6]


def _drive(router, vocab):
    rng = np.random.default_rng(3)
    reqs = []
    for i, (gen, arrival) in enumerate(zip(GENS, ARRIVALS)):
        try:
            reqs.append(router.submit(rng.integers(0, vocab, 4 + i % 3),
                                      gen, arrival_step=arrival))
        except (J.EngineSaturated, P.EngineSaturated):
            reqs.append(None)
        if i == 3:
            router.step()
            router.step()
    router.run()
    return [None if r is None else list(r.generated) for r in reqs]


@needs_jax
@pytest.mark.parametrize("max_waiting,hold", [(1, True), (2, True),
                                              (1, False)])
def test_router_matches_jax(max_waiting, hold):
    """Tokens, spills / overflowed / rebalanced / rejected_fleet and the
    fleet report's step-clock keys equal JAX's router on the same
    bounded-deque traffic."""
    jr, pr = _routers(max_waiting=max_waiting, hold_overflow=hold)
    vocab = models(DANUBE)[0].cfg.vocab
    assert _drive(pr, vocab) == _drive(jr, vocab)
    mine, theirs = pr.report(), jr.report()
    assert mine.keys() == theirs.keys()
    for k in STEP_KEYS:
        assert mine[k] == theirs[k], k
    if max_waiting == 2:
        assert pr.spills and pr.overflowed and pr.rebalanced
    if not hold:
        assert pr.rejected_fleet > 0
    assert "replicas" in pr.format_report()


@needs_jax
def test_aggregate_matches_jax():
    """ServeMetrics.aggregate over two engines' metrics (one slab, one
    paged with prefix reuse, so every pooled rate has both terms) equals
    JAX's on its step-clock keys, and its key set is report()'s plus
    n_replicas."""
    jm, pm = models(NEMOTRON)
    rng = np.random.default_rng(4)
    head = rng.integers(0, jm.cfg.vocab, 16)
    traffic = [(i, np.concatenate([head, rng.integers(0, jm.cfg.vocab, 3)]),
                4) for i in range(3)]
    pooled = []
    for pkg, m, kw in ((J, jm, {}), (P, pm, dict(device="cpu"))):
        metrics = []
        for page_size in (None, 8):
            eng = pkg.InferenceEngine(m, pkg.EngineConfig(
                n_slots=2, max_len=48, decode_chunk=2, page_size=page_size,
                **kw))
            for a, p, g in traffic:
                eng.submit(p, g, arrival_step=a)
            eng.run()
            metrics.append(eng.metrics)
        pooled.append(pkg.ServeMetrics.aggregate(metrics))
        assert pooled[-1].keys() == set(metrics[0].report()) | {"n_replicas"}
    theirs, mine = pooled
    assert mine.keys() == theirs.keys()
    for k in STEP_KEYS[:20]:
        assert mine[k] == theirs[k], k
    assert mine["prefill_tokens_skipped"] > 0


@needs_jax
def test_router_exports_match_jax(tmp_path):
    """A traced 2-replica router: one Chrome process per replica, and the
    Chrome events minus ts / dur, the JSONL lines minus the wall clock,
    equal JAX's."""
    out = []
    for pkg, m, kw in zip((J, P), models(DANUBE), ({}, dict(device="cpu"))):
        router = pkg.ReplicaRouter.build(m, pkg.EngineConfig(
            n_slots=2, max_len=32, trace=pkg.TraceConfig(), **kw), 2)
        router.submit([1, 2, 3], 3)
        router.submit([4, 5, 6], 3)
        router.submit([7, 8], 2, arrival_step=1)
        router.run()
        assert [t.replica for t in router.tracers] == [0, 1]
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        pkg.export_jsonl(router.tracers, path)
        lines = [{k: v for k, v in json.loads(line).items()
                  if k not in ("t", "dur", "epoch_wall")}
                 for line in open(path)]
        from repro.serve.trace import chrome_events as j_chrome
        chrome = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                  for t in router.tracers
                  for e in (chrome_events(t) if pkg is P else j_chrome(t))]
        out.append((lines, chrome))
    assert out[1] == out[0]
    assert {e["pid"] for e in out[1][1]} == {0, 1}


# ---------------------------------------------------------------------------
# the cases of tests/test_router_edges.py
# ---------------------------------------------------------------------------

def _prompt(vocab, n=4, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _port(arch=DANUBE, **kw):
    m = models(arch)[1]
    return m, P.EngineConfig(device="cpu", **kw)


def test_empty_fleet_is_rejected():
    with pytest.raises(ValueError, match="at least one replica"):
        P.ReplicaRouter([])


@needs_jax
def test_auto_restart_needs_a_factory():
    m, cfg = _port(n_slots=1, max_len=24)
    with pytest.raises(ValueError, match="engine_factory"):
        P.ReplicaRouter([P.InferenceEngine(m, cfg)], auto_restart=True)


@needs_jax
def test_all_saturated_fleet_parks_then_drains_overflow():
    """Every bounded deque full: the submit parks in the router's overflow
    deque (counted once, no extra spills on retry rounds) and drains into
    the first replica with queue headroom."""
    m, cfg = _port(n_slots=1, max_len=24, max_waiting=1)
    router = P.ReplicaRouter.build(m, cfg, 2)
    reqs = [router.submit(_prompt(m.cfg.vocab), 3) for _ in range(5)]
    assert router.overflowed == 3 and len(router._overflow) == 3
    spills_before = router.spills
    router.step()        # a still-saturated retry round must not re-spill
    assert router.spills == spills_before
    router.run()
    assert all(len(r.generated) == 3 for r in reqs)
    assert len(router._overflow) == 0
    rep = router.report()
    assert rep["requests_completed"] == 5.0 and rep["overflowed"] == 3.0


@needs_jax
def test_all_saturated_without_hold_raises():
    m, cfg = _port(n_slots=1, max_len=24, max_waiting=0)
    router = P.ReplicaRouter.build(m, cfg, 1, hold_overflow=False)
    with pytest.raises(P.EngineSaturated):
        router.submit(_prompt(m.cfg.vocab), 3)
    assert router.requests == []         # the failed submit is not tracked


@needs_jax
def test_single_replica_rebalance_is_a_noop():
    m, cfg = _port(n_slots=1, max_len=24)
    router = P.ReplicaRouter.build(m, cfg, 1)
    reqs = [router.submit(_prompt(m.cfg.vocab), 3) for _ in range(4)]
    eng = router.replicas[0]
    assert eng.n_waiting > eng.pool.n_free
    router._rebalance()
    assert router.rebalanced == 0
    assert eng.n_waiting + eng.pool.n_active == 4
    router.run()
    assert all(len(r.generated) == 3 for r in reqs)


@needs_jax
def test_steal_waiting_edge_cases():
    m, cfg = _port(n_slots=1, max_len=24)
    eng = P.InferenceEngine(m, cfg)
    assert eng.steal_waiting(3) == []
    reqs = [eng.submit(_prompt(m.cfg.vocab), 2, arrival_step=9)
            for _ in range(3)]
    stolen = eng.steal_waiting(99)       # more than exists: all, in order
    assert stolen == reqs
    assert eng.n_waiting == 0 and eng.requests == {}
    assert eng.metrics.records == {}
    assert all(r.id == -1 for r in stolen)
    assert eng.steal_waiting(1) == []


@needs_jax
def test_adopt_rehomes_stolen_requests_and_validates():
    """adopt() re-registers a stolen Request under a fresh id on the new
    engine and still enforces the admission bounds."""
    m, cfg = _port(n_slots=1, max_len=24)
    src, dst = P.InferenceEngine(m, cfg), P.InferenceEngine(m, cfg)
    r = src.submit(_prompt(m.cfg.vocab), 2)
    [stolen] = src.steal_waiting(1)
    assert stolen is r
    assert dst.adopt(stolen) is r and r.id >= 0
    assert dst.requests[r.id] is r
    dst.run()
    assert len(r.generated) == 2
    full, fcfg = _port(NEMOTRON, n_slots=1, max_len=8)
    with pytest.raises(ValueError):
        P.InferenceEngine(full, fcfg).submit(_prompt(full.cfg.vocab, n=6), 8)
    tight = P.InferenceEngine(m, P.EngineConfig(device="cpu", n_slots=1,
                                                max_len=24, max_waiting=0))
    with pytest.raises(P.EngineSaturated):
        tight.submit(_prompt(m.cfg.vocab), 2)
    assert tight.metrics.rejected == 1


@needs_jax
def test_fleet_rejection_reconciles():
    """Each replica counts its own bounce in `rejected`; the router counts
    the fleet-level refusal once in `rejected_fleet`."""
    m, cfg = _port(n_slots=1, max_len=24, max_waiting=0)
    router = P.ReplicaRouter.build(m, cfg, 2, hold_overflow=False)
    for _ in range(3):
        with pytest.raises(P.EngineSaturated):
            router.submit(_prompt(m.cfg.vocab), 3)
    rep = router.report()
    assert router.rejected_fleet == 3 and rep["rejected_fleet"] == 3.0
    assert [e.metrics.rejected for e in router.replicas] == [3, 3]
    assert rep["rejected"] == 6.0
    assert router.requests == []


@needs_jax
def test_evacuate_and_adopt_resume_the_stream():
    """evacuate() releases every slot and folds a running request's output
    into its prompt; adopt() on another engine budgets what is still owed,
    counts the failover, and the resumed greedy stream equals an
    uninterrupted run's."""
    m, cfg = _port(NEMOTRON, n_slots=2, max_len=32, page_size=8)
    clean = P.InferenceEngine(m, cfg)
    want = clean.submit(np.arange(5) + 3, 8)
    clean.run()
    src, dst = P.InferenceEngine(m, cfg), P.InferenceEngine(m, cfg)
    r = src.submit(np.arange(5) + 3, 8)
    waiting = src.submit(np.arange(4) + 1, 3, arrival_step=50)
    for _ in range(3):
        src.step()
    n_done = len(r.generated)
    assert 0 < n_done < 8
    moved = src.evacuate()
    assert moved == [r, waiting]
    assert src.pool.n_active == 0 and src.requests == {}
    assert int(src.pool.refs[1:].sum()) == src.pool.pages_in_use
    assert len(r.prompt) == 5 + n_done and r.state == "waiting"
    r.failover_from = 0
    dst.adopt(r)
    assert dst.metrics.failovers == 1 and r.failover_from == -1
    dst.run()
    assert r.generated == want.generated

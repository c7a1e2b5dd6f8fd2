"""Port parity, resilience: the QoS tier ladder and its controller,
deadlines (the doom-shed at admission, expiry in the queue and in flight),
cancellation and the bounded pool-wait backoff of `repro_torch`'s engine,
each held to `repro`'s on the same seeded weights and traffic (carried
through `checkpoint/convert.py`).

Every shed or cancel must release its slot (and pages on a paged pool), so
the pool drains to pristine: no stranded slot, no leaked refcount, and an
explicit terminal state (`state == "shed"` with a `shed_reason`). The
`cuda`-marked test replays each tier's graph against the eager step.
"""

import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry
    from repro.serve import QoSConfig as JQoSConfig
    from repro.serve import QoSController as JQoSController
    from repro.serve import check_tier_spec as jcheck_tier_spec
    from repro.serve import parse_tiers as jparse_tiers

from repro_torch.checkpoint.convert import convert
from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                               ModelRegistry, QoSConfig, QoSController,
                               check_tier_spec, parse_tiers)

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
DANUBE, NEMOTRON = "h2o-danube-1.8b", "nemotron-4-340b"
TIERS = (DraftSpec.from_args(8, 0.5, 0), DraftSpec.from_args(8, 0.75, 0))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX params, the port's dense params) on the same weights."""
    cfg = JC.get_smoke(arch)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return params, ported


@functools.lru_cache(maxsize=None)
def _models(arch, tiers=False, draft=False):
    """(JAX model, port model) on the carried weights."""
    params, ported = _carried(arch)
    kw = dict(tier_specs=TIERS) if tiers else {}
    jkw = dict(tier_specs=tuple(JDraftSpec.from_args(8, s, 0)
                                for s in (0.5, 0.75))) if tiers else {}
    if draft:
        kw["draft_spec"] = DraftSpec.from_args(8, 0.0, 0)
        jkw["draft_spec"] = JDraftSpec.from_args(8, 0.0, 0)
    return (JRegistry().load(arch, params=params, **jkw),
            ModelRegistry().load(arch, params=ported, device="cpu", **kw))


def _prompt(vocab, n=6, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n)


def _assert_pristine(eng):
    """Every slot free; on a paged pool every surviving page reference is
    the prefix tree's, and clearing the tree frees every page."""
    assert eng.pool.n_active == 0
    assert eng.pool.n_free == eng.cfg.n_slots
    if hasattr(eng.pool, "_free_pages"):
        if getattr(eng.pool, "index", None) is not None:
            assert eng.pool.pages_in_use == eng.pool.index.n_nodes
            eng.pool.index.clear(eng.pool._release)
        assert int(np.asarray(eng.pool.refs)[1:].sum()) == 0
        assert len(eng.pool._free_pages) == eng.pool.n_usable_pages


def _outcome(reqs):
    return [(r.state, r.shed_reason, r.tier, r.pool_retries,
             list(r.generated)) for r in reqs]


def _both(arch, cfg_kw, drive, **model_kw):
    """Run `drive(engine)` on JAX's engine and the port's, same config;
    returns ((JAX engine, its result), (port engine, its result))."""
    jm, pm = _models(arch, **model_kw)
    out = []
    for engine, cfg, m, extra in ((JEngine, JEngineConfig, jm, {}),
                                  (InferenceEngine, EngineConfig, pm,
                                   dict(device="cpu"))):
        kw = dict(cfg_kw, **extra)
        if "qos" in kw:
            q = kw["qos"]
            kw["qos"] = (JQoSConfig if engine is JEngine else QoSConfig)(
                **q)
        eng = engine(m, cfg(**kw))
        out.append((eng, drive(eng)))
    return out


# ---------------------------------------------------------------------------
# the controller and the tier specs, against the JAX package
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("knobs", [
    dict(demote_depth=4, promote_depth=1, hysteresis=2),
    dict(demote_depth=3, promote_depth=0, hysteresis=1, page_pressure=0.9),
    dict(demote_depth=8, promote_depth=2, hysteresis=4, page_pressure=0.6)])
def test_controller_tier_path_matches_jax(knobs):
    """The same seeded sequence of queue depths and page fractions gives
    the same tier path, in a 2- and a 3-tier ladder."""
    rng = np.random.default_rng(7)
    depths = rng.integers(0, 12, 400)
    fracs = rng.random(400)
    for n_tiers in (2, 3):
        mine = QoSController(QoSConfig(**knobs), n_tiers)
        ref = JQoSController(JQoSConfig(**knobs), n_tiers)
        got = [mine.observe(int(q), float(f)) for q, f in zip(depths, fracs)]
        want = [ref.observe(int(q), float(f)) for q, f in zip(depths, fracs)]
        assert got == want
        assert len(set(got)) == n_tiers          # the path visits every tier


@needs_jax
def test_qos_config_and_controller_refusals_match_jax():
    for bad in (dict(demote_depth=2, promote_depth=2), dict(hysteresis=0)):
        for cls in (QoSConfig, JQoSConfig):
            with pytest.raises(ValueError,
                               match="promote_depth|hysteresis"):
                cls(**bad)
    for ctrl, cfg in ((QoSController, QoSConfig),
                      (JQoSController, JQoSConfig)):
        with pytest.raises(ValueError, match="2 resident tiers"):
            ctrl(cfg(), n_tiers=1)


@needs_jax
def test_check_tier_spec_and_parse_tiers_match_jax():
    for check, spec in ((check_tier_spec, DraftSpec),
                        (jcheck_tier_spec, JDraftSpec)):
        with pytest.raises(ValueError, match="keep_layers"):
            check(spec.from_args(8, 0.5, 2))
        with pytest.raises(ValueError, match="cache_dtype"):
            check(spec(cache_dtype="bfloat16"))
        ts = spec.from_args(8, 0.5, 0)
        assert check(ts) is ts
    for arg in ("8:0.5,8:0.75", "4:0.5", "0:0.75,8"):
        got, want = parse_tiers(arg), jparse_tiers(arg)
        assert [t.tag for t in got] == [t.tag for t in want]
        assert [(t.bits, t.sparsity, t.bk, t.bn) for t in got] \
            == [(t.bits, t.sparsity, t.bk, t.bn) for t in want]
    for parse in (parse_tiers, jparse_tiers):
        with pytest.raises(ValueError, match="no tiers"):
            parse(" , ")


@needs_jax
def test_registry_keeps_tiers_resident():
    jm, m = _models(DANUBE, tiers=True)
    assert m.n_tiers == jm.n_tiers == 3
    assert m.tier_tree(0) is m.params
    assert m.tier_tree(1) is m.tier_params[0]
    assert m.tier_params[0] is not m.params
    assert m.name == jm.name and "tiers[" in m.name
    # tiers repack the same dense weights at their own point
    for tree, ts in zip(m.tier_params, TIERS):
        wq = tree["layers"][0]["mixer"]["wq"]
        assert wq.spec == ts.kratos_spec(m.spec)
    reg = ModelRegistry()
    plain = reg.load(DANUBE, device="cpu")
    tiered = reg.load(DANUBE, device="cpu", tier_specs=TIERS)
    assert plain is not tiered and plain.n_tiers == 1
    assert reg.load(DANUBE, device="cpu", tier_specs=TIERS) is tiered
    with pytest.raises(ValueError, match="keep_layers"):
        reg.load(DANUBE, device="cpu",
                 tier_specs=(DraftSpec.from_args(8, 0.5, 2),))


# ---------------------------------------------------------------------------
# tiers on a live engine
# ---------------------------------------------------------------------------

@needs_jax
def test_engine_degrades_and_recovers_like_jax():
    """A saturating burst demotes the engine down the ladder and the drain
    promotes it back; every request completes its budget, and every
    request's greedy tokens, its cheapest tier and the tier churn equal
    JAX's engine under the same QoSConfig (the ladder runs on the step
    clock)."""
    def drive(eng):
        rng = np.random.default_rng(1)
        reqs = [eng.submit(rng.integers(0, eng.model.cfg.vocab, 6), 8)
                for _ in range(8)]
        path = []
        while eng.n_waiting or eng.pool.n_active:
            eng.step()
            path.append(eng.tier)
        return reqs, path

    (jeng, (jreqs, jpath)), (eng, (reqs, path)) = _both(
        DANUBE, dict(n_slots=2, max_len=48,
                     qos=dict(demote_depth=3, promote_depth=0,
                              hysteresis=2)),
        drive, tiers=True)
    assert all(r.state == "done" and len(r.generated) == 8 for r in reqs)
    assert path == jpath and max(path) == 2 and path[-1] == 0
    assert _outcome(reqs) == _outcome(jreqs)
    rep, jrep = eng.metrics.report(), jeng.metrics.report()
    for key in ("tier_demotions", "tier_promotions", "decode_steps"):
        assert rep[key] == jrep[key], key
    assert rep["tier_demotions"] >= 1 and rep["tier_promotions"] >= 1
    assert eng.tier == 0 and max(r.tier for r in reqs) >= 1
    _assert_pristine(eng)


@needs_jax
def test_tier_zero_run_is_unchanged_by_resident_tiers():
    """Resident tiers do not perturb tier-0 serving: a tiered model's
    greedy tokens equal a tierless one's, and JAX's."""
    _, plain = _models(DANUBE)
    jm, tiered = _models(DANUBE, tiers=True)

    def run(m, engine=InferenceEngine, cfg=EngineConfig, **kw):
        eng = engine(m, cfg(n_slots=2, max_len=48, **kw))
        rs = [eng.submit(_prompt(m.cfg.vocab, seed=s), 6) for s in range(3)]
        eng.run()
        return [list(r.generated) for r in rs]

    want = run(plain, device="cpu")
    assert run(tiered, device="cpu") == want
    assert run(jm, JEngine, JEngineConfig) == want


def test_set_tier_swaps_params_and_refuses_out_of_range():
    m = ModelRegistry().load(DANUBE, device="cpu", tier_specs=TIERS)
    eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                          device="cpu"))
    r = eng.submit(_prompt(m.cfg.vocab), 6)
    eng.step()
    eng.set_tier(2)
    assert eng.backend.params is m.tier_params[1] and r.tier == 2
    eng.set_tier(1)
    assert eng.metrics.tier_demotions == 1
    assert eng.metrics.tier_promotions == 1 and r.tier == 2
    with pytest.raises(ValueError, match="out of range"):
        eng.set_tier(3)
    with pytest.raises(ValueError, match="2 resident tiers"):
        InferenceEngine(ModelRegistry().load(DANUBE, device="cpu"),
                        EngineConfig(device="cpu", qos=QoSConfig()))


# ---------------------------------------------------------------------------
# deadlines: the doom-shed at admission, expiry in the queue and in flight
# ---------------------------------------------------------------------------

def _deadline_traffic(scenario):
    def drive(eng):
        v = eng.model.cfg.vocab
        if scenario == "doomed":
            doomed = eng.submit(_prompt(v), 12, deadline_steps=3)
            assert doomed.state == "shed" and eng.n_waiting == 0
            reqs = [doomed, eng.submit(_prompt(v), 4, deadline_steps=50)]
        elif scenario == "queued":
            reqs = [eng.submit(_prompt(v), 10),
                    eng.submit(_prompt(v, seed=1), 10, deadline_steps=12)]
        else:
            rng = np.random.default_rng(3)
            reqs = [eng.submit(rng.integers(0, v, 5), 8, deadline_steps=14)
                    for _ in range(6)]
        eng.run()
        return reqs
    return drive


@needs_jax
@pytest.mark.parametrize("scenario", ["doomed", "queued", "in_flight"])
def test_deadlines_shed_like_jax(scenario):
    """Doomed at admission: shed before taking a slot. Queued: shed in
    the queue once the backlog dooms it. In flight: every request either
    finishes by its deadline or is shed. The ids shed, their reasons and
    every survivor's tokens equal JAX's engine."""
    n_slots = 1 if scenario == "queued" else 2
    (jeng, jreqs), (eng, reqs) = _both(
        DANUBE, dict(n_slots=n_slots, max_len=48), _deadline_traffic(scenario))
    assert _outcome(reqs) == _outcome(jreqs)
    rep, jrep = eng.metrics.report(), jeng.metrics.report()
    for key in ("shed", "deadline_missed", "requests_completed"):
        assert rep[key] == jrep[key], key
    assert rep["deadline_missed"] >= 1
    assert any(r.state == "done" for r in reqs)
    for r in reqs:
        if r.state == "done" and r.deadline_steps is not None:
            assert eng.metrics.records[r.id].finish_step \
                <= r.arrival_step + r.deadline_steps
    _assert_pristine(eng)


def test_wall_deadline_sheds_in_flight():
    """deadline_ms runs on the wall clock from submit: a request past it is
    shed at the next step, its slot freed."""
    m = ModelRegistry().load(DANUBE, device="cpu")
    eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                          device="cpu"))
    keep = eng.submit(_prompt(m.cfg.vocab), 8)
    late = eng.submit(_prompt(m.cfg.vocab, seed=1), 8, deadline_ms=60_000.0)
    eng.step()
    eng.step()                              # one admission a step
    assert late.state == "running"
    eng.metrics.records[late.id].submit_mono -= 120.0     # two minutes ago
    eng.run()
    assert late.state == "shed" and late.shed_reason == "deadline"
    assert keep.state == "done" and len(keep.generated) == 8
    _assert_pristine(eng)


# ---------------------------------------------------------------------------
# cancellation across serving modes
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("mode,paging", [
    ("device", "slab"), ("device", "paged"), ("host", "slab"),
    ("spec", "slab"), ("spec", "paged")])
def test_midflight_cancel_is_clean(mode, paging):
    """Cancel one running and one queued request mid-decode: both end
    "shed" with reason 'cancel', the survivors complete their budgets with
    JAX's greedy tokens, and the pool drains to pristine (slots and page
    refcounts)."""
    kw = dict(n_slots=2, max_len=48)
    if mode == "host":
        kw["device_loop"] = False
    if mode == "spec":
        kw["speculate"] = 3
    if paging == "paged":
        kw["page_size"] = 8

    def drive(eng):
        v = eng.model.cfg.vocab
        reqs = [eng.submit(_prompt(v, seed=s), 8) for s in range(4)]
        for _ in range(3):                   # two running, two queued
            eng.step()
        running = next(r for r in reqs if r.state == "running")
        queued = next(r for r in reqs if r.state == "waiting")
        eng.cancel(running)
        eng.cancel(queued)
        eng.cancel(running)                  # a no-op on a shed request
        eng.run()
        return reqs, (running.id, queued.id)

    arch = NEMOTRON if mode == "spec" else DANUBE
    (jeng, (jreqs, jids)), (eng, (reqs, ids)) = _both(
        arch, kw, drive, draft=mode == "spec")
    assert ids == jids
    assert [(r.state, r.shed_reason) for r in reqs if r.id in ids] \
        == [("shed", "cancel")] * 2
    survivors = [r for r in reqs if r.id not in ids]
    assert all(r.state == "done" and len(r.generated) == 8
               for r in survivors)
    assert _outcome(reqs) == _outcome(jreqs)
    assert eng.metrics.shed == 2
    _assert_pristine(eng)


def test_cancel_does_not_change_survivor_tokens():
    m = ModelRegistry().load(DANUBE, device="cpu")

    def run(cancel):
        eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                              device="cpu"))
        keep = eng.submit(_prompt(m.cfg.vocab, seed=0), 8)
        victim = eng.submit(_prompt(m.cfg.vocab, seed=1), 8)
        if cancel:
            for _ in range(2):
                eng.step()
            eng.cancel(victim)
        eng.run()
        return list(keep.generated)

    assert run(cancel=False) == run(cancel=True)


def test_on_token_streams_every_token():
    m = ModelRegistry().load(DANUBE, device="cpu")
    eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                          decode_chunk=4, device="cpu"))
    seen = []
    rs = [eng.submit(_prompt(m.cfg.vocab, seed=s), 7, slo="batch",
                     on_token=lambda r, t: seen.append((r.id, t)))
          for s in range(3)]
    eng.run()
    for r in rs:
        assert [t for i, t in seen if i == r.id] == r.generated
        assert r.slo == "batch" and r.finished


# ---------------------------------------------------------------------------
# pool-wait backoff, then shed
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("retries", [2, None])
def test_pool_wait_backoff_matches_jax(retries):
    """A page pool one long resident starves: with pool_wait_retries the
    second request retries on an exponential step backoff and is shed
    ('pool') past the cap; unbounded (None), it waits and completes. The
    shed ids, the retry and wait counts and every token equal JAX's."""
    def drive(eng):
        v = eng.model.cfg.vocab
        reqs = [eng.submit(_prompt(v), 20),
                eng.submit(_prompt(v, seed=1), 20)]
        eng.run()
        return reqs

    (jeng, jreqs), (eng, reqs) = _both(
        NEMOTRON, dict(n_slots=2, max_len=48, page_size=8, n_pages=7,
                       pool_wait_retries=retries), drive)
    assert _outcome(reqs) == _outcome(jreqs)
    rep, jrep = eng.metrics.report(), jeng.metrics.report()
    for key in ("shed", "shed_pool_pressure", "pool_waits",
                "requests_completed", "decode_steps"):
        assert rep[key] == jrep[key], key
    hog, starved = reqs
    assert hog.state == "done" and len(hog.generated) == 20
    if retries is None:
        assert starved.state == "done" and rep["shed"] == 0
    else:
        assert starved.state == "shed" and starved.shed_reason == "pool"
        assert starved.pool_retries == retries + 1
        assert rep["shed_pool_pressure"] == 1 and rep["pool_waits"] >= 3
    _assert_pristine(eng)


def test_pool_wait_retries_validated():
    with pytest.raises(ValueError, match="pool_wait_retries"):
        EngineConfig(device="cpu", pool_wait_retries=-1)


# ---------------------------------------------------------------------------
# on the card: one graph per tier
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(decode_chunk=4),
                                dict(decode_chunk=2, page_size=8)])
def test_cuda_each_tier_graph_matches_eager(cuda_device, kw):
    """Every tier's captured graph gives the eager step's tokens on the
    same traffic, the engine held on that tier; a swap selects a graph
    (one per tier, captured at build) and captures nothing."""
    m = ModelRegistry().load(DANUBE, device="cuda", tier_specs=TIERS)
    out = {}
    for eager in (False, True):
        for tier in range(m.n_tiers):
            eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                                  **kw))
            assert len(eng.backend._graphs) == m.n_tiers
            eng.set_tier(tier)
            if eager:
                eng.backend._graph = None
            rs = [eng.submit(_prompt(m.cfg.vocab, seed=s), 8)
                  for s in range(3)]
            eng.run()
            out[eager, tier] = [list(r.generated) for r in rs]
    for tier in range(m.n_tiers):
        assert out[False, tier] == out[True, tier]

"""Port parity, the ineffectual-work ledger: the probe's plain version and
the engine's drained counters of `repro_torch` against `repro`'s on the
same seeded numpy activations, weights and traffic.

The contract, as the JAX package's: zero cost when off (NULL_LEDGER
allocates nothing), no extra host sync when on (the matrix rides the
dispatch's one host copy), bit-deterministic across identical runs,
token-neutral (probes observe, never perturb), and per-tier quality
gauges equal to the reference's. The probe's counts equal JAX's exactly on
the same activations; end to end the activations themselves differ by f32
rounding between the two frameworks, so a pre-activation within an ulp of
0 can land on the other side of it: there the zero and dead-block
fractions are held within 1e-3 (absolute), the structural columns
(elements, groups, k-blocks, dense FLOPs and bytes) exactly. The
`cuda`-marked tests hold the probe kernel to the plain version and the
graphed ledger to the eager step.
"""

import functools
import gc
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import LedgerConfig as JLedgerConfig
    from repro.serve import ModelRegistry as JRegistry
    from repro.serve import hist_checksum as jhist_checksum
    from repro.serve.ledger import LedgerProbe as JLedgerProbe

from repro_torch.checkpoint.convert import convert
from repro_torch.kernels import ops
from repro_torch.models import transformer as PT
from repro_torch.serve import (NULL_LEDGER, DraftSpec, EngineConfig,
                               InferenceEngine, LedgerConfig, LedgerSink,
                               ModelRegistry, hist_checksum)
from repro_torch.serve.ledger import (C_BYTES_DENSE, C_BYTES_EFF, C_DEAD_KB,
                                      C_ELEMS, C_FLOPS_DENSE, C_FLOPS_EFF,
                                      C_GROUPS, C_HIST, C_KBLOCKS, C_NEAR,
                                      C_ZEROS, LedgerProbe)

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
NEMOTRON, DANUBE = "nemotron-4-340b", "h2o-danube-1.8b"
# the columns that are integers or shape-only (exact), and the two float
# columns formed from them (within 1e-6 relative)
COUNTS = [C_ELEMS, C_ZEROS, C_NEAR, C_GROUPS, C_KBLOCKS, C_DEAD_KB,
          C_FLOPS_DENSE, C_BYTES_DENSE]
STRUCTURAL = [C_ELEMS, C_GROUPS, C_KBLOCKS, C_FLOPS_DENSE, C_BYTES_DENSE]
FRACTION_TOL = 1e-3       # end to end: activations differ by f32 rounding


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
def _models(arch, draft=False, tiers=False):
    params, ported = _carried(arch)
    kw, jkw = {}, {}
    if draft:
        kw["draft_spec"], jkw["draft_spec"] = DraftSpec(bits=8), \
            JDraftSpec(bits=8)
    if tiers:
        kw["tier_specs"] = (DraftSpec.from_args(8, 0.5, 0),)
        jkw["tier_specs"] = (JDraftSpec.from_args(8, 0.5, 0),)
    return (JRegistry().load(arch, params=params, **jkw),
            ModelRegistry().load(arch, params=ported, device="cpu", **kw))


def _trace(vocab, n=3, prompt=8, gen=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, prompt), gen) for i in range(n)]


def _run(model, trace, *, ledger=None, decode_chunk=2, jax_engine=False,
         **cfg_kw):
    if jax_engine:
        eng = JEngine(model, JEngineConfig(
            n_slots=2, max_len=48, decode_chunk=decode_chunk,
            ledger=None if ledger is None else JLedgerConfig(
                **vars(ledger)), **cfg_kw))
    else:
        eng = InferenceEngine(model, EngineConfig(
            n_slots=2, max_len=48, decode_chunk=decode_chunk, ledger=ledger,
            device="cpu", **cfg_kw))
    reqs = [eng.submit(p, g, arrival_step=a) for a, p, g in trace]
    eng.run()
    return eng, [list(r.generated) for r in reqs]


def _assert_summaries_close(got, want):
    """Structural totals exact; zero, near-zero and dead-block fractions
    (pooled and per layer) within FRACTION_TOL; FLOP and byte effective
    shares too."""
    for key in ("n_layers", "act_probe_elems", "act_kblocks", "flops_dense",
                "bytes_dense"):
        assert got[key] == want[key], key
    elems, kb = want["act_probe_elems"], want["act_kblocks"]
    for key, den in (("act_zeros", elems), ("act_near_zeros", elems),
                     ("act_dead_kblocks", kb),
                     ("flops_effective", want["flops_dense"]),
                     ("bytes_effective", want["bytes_dense"])):
        assert abs(got[key] - want[key]) / den <= FRACTION_TOL, key
    for key in ("zero_fraction_by_layer", "dead_kblock_fraction_by_layer"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=FRACTION_TOL)


# ---------------------------------------------------------------------------
# off: zero cost
# ---------------------------------------------------------------------------

def test_null_ledger_zero_alloc():
    """The disabled sink's hot-path calls (one a dispatch) allocate
    nothing."""
    led = NULL_LEDGER

    def hot_path():
        led.on_drain(None, 7)
        led.rebase()

    deltas = []
    for _ in range(3):
        hot_path()
        gc.collect()
        before = sys.getallocatedblocks()
        hot_path()
        deltas.append(sys.getallocatedblocks() - before)
    assert deltas[-1] == 0, f"disabled ledger allocated: deltas={deltas}"
    assert not led.enabled and led.summary() == {}


def test_ledger_requires_device_loop():
    with pytest.raises(ValueError, match="device_loop"):
        EngineConfig(device="cpu", device_loop=False, ledger=LedgerConfig())


# ---------------------------------------------------------------------------
# the probe against the JAX package's on the same activations
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("knobs,shape,n_out", [
    (dict(), (2, 1, 64), 256),
    (dict(threshold=0.25, group=4, k_block=4), (3, 16), 8),
    (dict(threshold=0.3, group=8, k_block=8), (2, 5, 72), 96),   # ragged
    (dict(threshold=0.0, group=6, k_block=32), (4, 20), 64),     # d < k_block
    (dict(threshold=1e-3, group=8, k_block=32), (8, 1, 6912), 2560)])
def test_probe_measure_matches_jax(knobs, shape, n_out):
    """Counts and shape columns equal, the effective FLOP and byte
    columns within 1e-6 relative; the wrapper's CPU path adds exactly the
    plain row into a ledger row."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    x[np.abs(x) < 0.4] = 0.0                   # plenty of exact zeros
    x[rng.random(shape) < 0.1] *= 1e-4         # and near-zeros
    cfg = LedgerConfig(**knobs)
    got = LedgerProbe(cfg, torch.zeros(1, cfg.width)).measure(
        torch.from_numpy(x), n_out).numpy()
    want = np.asarray(JLedgerProbe(JLedgerConfig(**knobs)).measure(
        jnp.asarray(x), n_out))
    assert got.shape == want.shape == (cfg.width,)
    assert np.array_equal(got[COUNTS], want[COUNTS])
    assert np.array_equal(got[C_HIST:], want[C_HIST:])
    for col in (C_FLOPS_EFF, C_BYTES_EFF):
        np.testing.assert_allclose(got[col], want[col], rtol=1e-6)
    assert got[C_ZEROS] > 0
    row = torch.zeros(cfg.width)
    ops.ledger_probe(torch.from_numpy(x), n_out, row, threshold=cfg.threshold,
                     group=cfg.group, k_block=cfg.k_block)
    assert torch.equal(row, torch.from_numpy(got))


@needs_jax
def test_hist_checksum_matches_jax_and_orders():
    a = np.zeros((2, C_HIST + 5))
    b = np.zeros((2, C_HIST + 5))
    a[0, C_HIST] = 3.0
    b[0, C_HIST + 2] = 3.0
    assert hist_checksum(a, 4) != hist_checksum(b, 4)
    m = np.random.default_rng(2).integers(0, 50, (4, C_HIST + 9))
    assert hist_checksum(m, 8) == jhist_checksum(m, 8)


@needs_jax
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "gemma2-27b",
                                  "deepseek-moe-16b", "minicpm3-4b"])
def test_forward_probe_matrix_in_layer_order(arch):
    """A prefill's probe matrix against JAX's `T.forward(probe=)`: each
    row lands on its own layer under the port's `layer_order` (jamba's 8
    scan slots of Mamba, attention, MoE and MLP layers; gemma2's local
    layers before its global ones; deepseek's dense prelude; MLA's
    fan-out): the structural columns equal row by row, the near-zero
    counts within the end-to-end tolerance."""
    params, _ = _carried(arch)
    _, m = _models(arch)                  # packed at the config's own spec
    jcfg, pcfg = JC.get_smoke(arch), m.cfg
    led = LedgerConfig(threshold=0.05, group=8, k_block=8)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 12))
    _, _, _, want = JT.forward(params, jnp.asarray(tokens), jcfg,
                               probe=JLedgerProbe(JLedgerConfig(**vars(led))))
    want = np.asarray(want)
    got = torch.zeros(pcfg.n_layers, led.width)
    with torch.no_grad():
        PT.forward(m.params, torch.from_numpy(tokens), pcfg,
                   probe=LedgerProbe(led, got))
    got = got.numpy()
    assert np.array_equal(got[:, STRUCTURAL], want[:, STRUCTURAL])
    if arch.startswith(("jamba", "deepseek")):
        assert len(set(got[:, C_FLOPS_DENSE])) > 1    # rows tell apart
    near = np.abs(got[:, C_NEAR] - want[:, C_NEAR]) / want[:, C_ELEMS]
    assert near.max() <= FRACTION_TOL
    assert want[:, C_NEAR].sum() > 0


# ---------------------------------------------------------------------------
# the engine: sync economy, neutrality, determinism, against JAX
# ---------------------------------------------------------------------------

def _record_decode_host_reads(monkeypatch, backend, method="decode_block"):
    """Every tensor-to-host read made inside a decode dispatch."""
    reads, active = [], [False]
    for name in ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__"):
        def wrapped(self, *a, _orig=getattr(torch.Tensor, name), _name=name,
                    **kw):
            if active[0]:
                reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    inner = getattr(backend, method)

    def counted(*a, **kw):
        active[0] = True
        try:
            return inner(*a, **kw)
        finally:
            active[0] = False
    monkeypatch.setattr(backend, method, counted)
    return reads


@needs_jax
def test_ledger_neutral_syncless_deterministic_and_matches_jax(monkeypatch):
    """nemotron's squared ReLU makes real zeros. With the ledger on: the
    same greedy tokens as off, one host read a dispatch (the token block
    and the matrix in one copy), host_syncs_decode equal to the dispatch
    count and to the off engine's, two runs bit-identical (every counter,
    the histogram matrix and its checksum), and the summary equal to JAX's
    engine on the same trace (within the stated tolerance)."""
    jm, m = _models(NEMOTRON)
    trace = _trace(m.cfg.vocab)
    led = LedgerConfig(k_block=8)
    off, toks_off = _run(m, trace)
    on = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                         decode_chunk=2, ledger=led,
                                         device="cpu"))
    reads = _record_decode_host_reads(monkeypatch, on.backend)
    reqs = [on.submit(p, g, arrival_step=a) for a, p, g in trace]
    on.run()
    monkeypatch.undo()
    assert [list(r.generated) for r in reqs] == toks_off
    rep, rep_off = on.metrics.report(), off.metrics.report()
    assert reads == ["cpu"] * int(rep["decode_steps"])
    assert rep["host_syncs_decode"] == rep["decode_steps"] \
        == rep_off["host_syncs_decode"] == rep["ledger_dispatches"]
    assert rep["host_syncs_quality"] == 0
    again, _ = _run(m, trace, ledger=led)
    s = on.ledger.summary()
    assert again.ledger.summary() == s
    assert s["act_zeros"] > 0 and 0.0 < rep["act_zero_fraction"] < 1.0
    assert rep["flops_effective"] <= rep["flops_dense"]
    assert rep["bytes_effective"] <= rep["bytes_dense"]
    assert rep["act_probe_elems"] == s["act_probe_elems"]
    assert rep["act_zeros"] == s["act_zeros"]
    jeng, jtoks = _run(jm, trace, ledger=led, jax_engine=True)
    assert jtoks == toks_off
    _assert_summaries_close(s, jeng.ledger.summary())


def test_ledger_paged_matches_slab():
    """The paged dispatch carries the same buffer: the same greedy tokens
    as the slab, zero fractions within 0.01 (layouts may differ by an ulp
    at borderline activations), and the paged run deterministic."""
    m = ModelRegistry().load(NEMOTRON, device="cpu")
    trace = _trace(m.cfg.vocab)
    led = LedgerConfig(k_block=8)
    slab, toks_slab = _run(m, trace, ledger=led)
    paged, toks_paged = _run(m, trace, ledger=led, page_size=8)
    assert toks_slab == toks_paged
    ss, sp = slab.ledger.summary(), paged.ledger.summary()
    assert sp["act_zeros"] > 0
    assert abs(ss["act_zeros"] / ss["act_probe_elems"]
               - sp["act_zeros"] / sp["act_probe_elems"]) < 0.01
    again, _ = _run(m, trace, ledger=led, page_size=8)
    assert again.ledger.summary() == sp


@needs_jax
def test_ledger_speculative_counts_target_only():
    """A speculating dispatch probes the target's verify forward only: the
    ledger drains once a cycle, tokens equal the unledgered engine's and
    JAX's, and the totals equal JAX's speculating engine (its probed
    elements exactly: the target's block alone)."""
    jm, m = _models(NEMOTRON, draft=True)
    trace = _trace(m.cfg.vocab)
    led = LedgerConfig(k_block=8)
    off, toks_off = _run(m, trace, speculate=2, decode_chunk=1)
    on, toks_on = _run(m, trace, speculate=2, decode_chunk=1, ledger=led)
    assert toks_on == toks_off
    rep = on.metrics.report()
    assert rep["ledger_dispatches"] == rep["spec_dispatches"]
    assert rep["act_zeros"] > 0
    assert rep["host_syncs_decode"] == off.metrics.report()["host_syncs_decode"]
    # the target's (B, K+1) block a cycle, at the target's widths only
    cfg = m.cfg
    # a layer's taps: the mixer and FFN inputs, wo's and w_down's inputs
    taps = 2 * cfg.d_model + cfg.n_heads * cfg.dh + cfg.d_ff
    assert rep["act_probe_elems"] == rep["spec_dispatches"] * 2 * 3 \
        * taps * cfg.n_layers
    jeng, jtoks = _run(jm, trace, speculate=2, decode_chunk=1, ledger=led,
                       jax_engine=True)
    assert jtoks == toks_on
    _assert_summaries_close(on.ledger.summary(), jeng.ledger.summary())


@needs_jax
def test_suffix_prefill_adds_to_the_ledger_like_jax():
    """A prefix-hit admission's suffix prefill adds its rows on the device;
    the next dispatch's copy drains them: totals equal JAX's paged engine
    (minicpm3's MLA, prefix reuse on)."""
    arch = "minicpm3-4b"
    jm, m = _models(arch)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, m.cfg.vocab, 16)
    trace = [(i, np.concatenate([shared, rng.integers(0, m.cfg.vocab, 4)]),
              5) for i in range(3)]
    led = LedgerConfig(threshold=0.05, k_block=8)
    eng, toks = _run(m, trace, ledger=led, page_size=8)
    jeng, jtoks = _run(jm, trace, ledger=led, page_size=8, jax_engine=True)
    assert toks == jtoks
    assert eng.metrics.report()["prefill_tokens_skipped"] > 0
    _assert_summaries_close(eng.ledger.summary(), jeng.ledger.summary())


# ---------------------------------------------------------------------------
# quality probes
# ---------------------------------------------------------------------------

@needs_jax
def test_quality_gauges_match_jax():
    """On one tier the tier-0 shadow is the same prefill: top-1 rate 1.0,
    mad 0.0, two quality syncs a probe and the decode syncs unmoved. Held
    on tier 1 (s0.5-w8) the log equals JAX's: top-1 equal, mad within
    1e-4, and quality_by_tier recomputes from the log."""
    _, m = _models(NEMOTRON)
    eng, _ = _run(m, _trace(m.cfg.vocab, n=4),
                  ledger=LedgerConfig(quality_every=2))
    rep = eng.metrics.report()
    assert rep["quality_probes"] == len(eng.quality_log) == 2
    assert rep["host_syncs_quality"] == 2 * rep["quality_probes"]
    assert rep["host_syncs_decode"] == rep["decode_steps"]
    assert rep["quality_top1_rate"] == 1.0 and rep["quality_logit_mad"] == 0.0

    jm, m = _models(DANUBE, tiers=True)
    logs = []
    for engine, cfg, model, kw in (
            (JEngine, JEngineConfig, jm,
             dict(ledger=JLedgerConfig(quality_every=1))),
            (InferenceEngine, EngineConfig, m,
             dict(ledger=LedgerConfig(quality_every=1), device="cpu"))):
        e = engine(model, cfg(n_slots=2, max_len=48, **kw))
        e.set_tier(1)
        for _, p, g in _trace(m.cfg.vocab, n=3):
            e.submit(p, g)
        e.run()
        logs.append(e)
    jeng, eng = logs
    assert [(q["rid"], q["tier"], q["top1"]) for q in eng.quality_log] \
        == [(q["rid"], q["tier"], q["top1"]) for q in jeng.quality_log]
    np.testing.assert_allclose([q["mad"] for q in eng.quality_log],
                               [q["mad"] for q in jeng.quality_log],
                               rtol=0, atol=1e-4)
    assert all(q["tier"] == 1 and q["mad"] > 0 for q in eng.quality_log)
    by = eng.metrics.quality_by_tier()
    assert by[1]["probes"] == 3
    assert by[1]["logit_mad"] == pytest.approx(
        np.mean([q["mad"] for q in eng.quality_log]))


# ---------------------------------------------------------------------------
# sink accounting and the in-place rebase
# ---------------------------------------------------------------------------

def test_sink_delta_and_rebase():
    cfg = LedgerConfig(group=2, k_block=2)
    sink = LedgerSink(cfg, n_layers=2)
    cum = np.zeros((2, cfg.width), np.float32)
    cum[0, C_ELEMS] = 10.0
    sink.on_drain(cum, step=1)
    cum2 = cum.copy()
    cum2[0, C_ELEMS] = 25.0
    sink.on_drain(cum2, step=2)
    assert sink.total[0, C_ELEMS] == 25.0
    sink.rebase()                    # device buffer was zeroed
    cum3 = np.zeros_like(cum)
    cum3[0, C_ELEMS] = 5.0
    sink.on_drain(cum3, step=3)
    assert sink.total[0, C_ELEMS] == 30.0


def test_backend_rebase_zeroes_the_same_tensor():
    """Past 2**23 in any cell the backend zeroes its buffer IN PLACE (a
    captured graph keeps writing the same address) and the sink's totals
    keep growing across it."""
    m = ModelRegistry().load(NEMOTRON, device="cpu")
    eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                          ledger=LedgerConfig(),
                                          device="cpu"))
    bk = eng.backend
    ptr = bk.ledger_buf.data_ptr()
    assert not bk.maybe_rebase_ledger()            # nothing drained yet
    for _, p, g in _trace(m.cfg.vocab, n=2):
        eng.submit(p, g)
    eng.step()
    before = eng.ledger.total.copy()
    bk.ledger_buf[0, C_FLOPS_DENSE] = 2.0 ** 23
    bk.last_ledger = bk.ledger_buf.numpy().copy()
    assert bk.maybe_rebase_ledger()
    assert bk.ledger_buf.data_ptr() == ptr
    assert not bk.ledger_buf.any() and bk.last_ledger is None
    eng.ledger.rebase()
    eng.run()
    assert (eng.ledger.total[:, C_ELEMS] > before[:, C_ELEMS]).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("knobs,shape,n_out", [
    (dict(), (8, 1, 2560), 3840), (dict(), (8, 1, 6912), 2560),
    (dict(threshold=1e-3), (1, 512, 6912), 2560),
    (dict(threshold=0.3, group=6, k_block=24), (5, 77), 96)])
def test_cuda_probe_kernel_matches_plain_version(cuda_device, dtype, knobs,
                                                 shape, n_out):
    """The kernel's row equals `LedgerProbe.measure` on the same tensor:
    counts exactly, the float columns within 1e-6 relative; it adds into
    the row in place, and a second launch gives the same bits again."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=gen, device="cuda")
    x = torch.where(x.abs() < 0.4, torch.zeros_like(x), x).to(
        getattr(torch, dtype))
    cfg = LedgerConfig(**knobs)
    want = LedgerProbe(cfg, torch.zeros(1, cfg.width)).measure(x, n_out)
    rows = torch.zeros(2, cfg.width, device="cuda")
    for row in rows:
        ops.ledger_probe(x, n_out, row, threshold=cfg.threshold,
                         group=cfg.group, k_block=cfg.k_block)
    got = rows.cpu()
    assert torch.equal(got[0], got[1])
    want = want.cpu()
    cols = COUNTS + list(range(C_HIST, cfg.width))
    assert torch.equal(got[0, cols], want[cols])
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)
    twice = rows[0].clone()
    ops.ledger_probe(x, n_out, twice, threshold=cfg.threshold,
                     group=cfg.group, k_block=cfg.k_block)
    assert torch.equal(twice.cpu()[cols], 2 * want[cols])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(decode_chunk=4),
                                dict(decode_chunk=2, page_size=8),
                                dict(speculate=2)])
def test_cuda_graphed_ledger_matches_eager(cuda_device, kw):
    """The graphed dispatch's ledger (the probe kernel inside the graph)
    equals the eager step's bit for bit, the tokens equal the unledgered
    engine's, and decode syncs stay one a dispatch."""
    m = ModelRegistry().load(NEMOTRON, device="cuda",
                             draft_spec=DraftSpec(bits=8))
    trace = _trace(m.cfg.vocab)
    out = []
    for eager, led in ((False, None), (False, LedgerConfig(k_block=8)),
                       (True, LedgerConfig(k_block=8))):
        eng = InferenceEngine(m, EngineConfig(n_slots=2, max_len=48,
                                              ledger=led, **kw))
        if eager:
            eng.backend._graph = None
        reqs = [eng.submit(p, g, arrival_step=a) for a, p, g in trace]
        ops.reset_launch_counts()
        eng.run()
        rep = eng.metrics.report()
        assert rep["host_syncs_decode"] == rep["decode_steps"]
        assert (ops.launch_counts()["ledger_probe"] > 0) == (led is not None)
        out.append(([list(r.generated) for r in reqs],
                    eng.ledger.summary()))
    assert out[0][0] == out[1][0] == out[2][0]
    assert out[1][1] == out[2][1] and out[1][1]["act_zeros"] > 0

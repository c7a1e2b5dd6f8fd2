"""Port parity, gemma2 (local/global windows, attention and logit softcaps,
sandwich norms, (1+w) RMSNorm, a query scale of its own).

On the CPU, at the smoke config (window 8), JAX weights carried across by
`checkpoint.convert`:
  * `layer_kind` and `param_count` equal JAX's for the full config, and the
    layers run in the JAX package's order (each scan slot's stack in turn);
  * the forward (prefill, then decode past the window through the local
    layers' circular caches, per-slot clocks) matches JAX `T.forward` on
    `ref` and Pallas `interpret` within 1e-4 on the logits;
  * flash and paged attention's plain versions with softcap 50 and the
    gemma2 query scale, at d = 16 and d = 128, match the Pallas kernels in
    interpret mode within 2e-3;
  * greedy engine tokens equal JAX's engine: slab (requests longer than the
    window), paged (local layers resident; with the window widened past
    max_len, every layer page-major), speculative decode with the window
    widened past max_len + K (the smoke window is refused with "window");
  * a request past max_len is refused at submit, as in JAX: the global
    layers bound the length.
`cuda`-marked tests hold the flash and paged kernels at d = 128 with
softcap and window to their plain versions, and a graphed gemma2 engine to
the eager step, on the card."""

import dataclasses
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
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.kernels import ops as jops
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import transformer as PT
from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                               ModelRegistry)

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
GEMMA = "gemma2-27b"
SCALE = (4608 / 32) ** -0.5           # the full config's query scale, 1/12
# (prompt length, new tokens): past the smoke window of 8, mixed lengths
JOBS = ((5, 7), (11, 6), (9, 9), (3, 4))
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _jobs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0).astype(np.int32), g) for s0, g in JOBS]


def _run(eng, jobs):
    reqs = [eng.submit(p, g, arrival_step=i) for i, (p, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _carried(window=8):
    """(JAX smoke cfg, JAX params, the port's dense params): same weights."""
    cfg = JC.get_smoke(GEMMA, window=window)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported


def _port_model(window=8, draft_spec=None):
    cfg, _, ported = _carried(window)
    reg = ModelRegistry()
    model = reg.load(GEMMA, params=ported, device="cpu",
                     draft_spec=draft_spec)
    if window != 8:
        # the registry loads the smoke config; widen its window as the JAX
        # side's was widened
        model.cfg = dataclasses.replace(model.cfg, window=window)
        if model.has_draft:
            model.draft_cfg = dataclasses.replace(model.draft_cfg,
                                                  window=window)
    return model


# ---------------------------------------------------------------------------
# config and layer pattern
# ---------------------------------------------------------------------------

@needs_jax
def test_layer_kind_and_param_count_match_jax():
    for get in ("get_config", "get_smoke"):
        jcfg, pcfg = getattr(JC, get)(GEMMA), getattr(PC, get)(GEMMA)
        kinds = [PT.layer_kind(pcfg, i) for i in range(pcfg.n_layers)]
        assert kinds == [JT.layer_kind(jcfg, i) for i in range(jcfg.n_layers)]
        assert pcfg.param_count() == jcfg.param_count()
        assert kinds[0]["window"] == pcfg.window and kinds[1]["window"] is None
    assert PC.get_config(GEMMA).param_count() == 27_226_275_840
    # the JAX package runs each scan slot's stack in turn: the local
    # layers 0, 2, 4, ..., then the global ones
    assert PT.layer_order(PC.get_smoke(GEMMA)) == [0, 2, 1, 3]
    assert PT.layer_order(PC.get_config(GEMMA))[:24] == list(range(0, 46, 2)) \
        + [1]


@needs_jax
@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_forward_matches_jax(backend):
    """Prefill 10 tokens (past the window), then decode 8 steps with
    per-slot clocks through the circular local caches and the full global
    ones."""
    cfg, params, _ = _carried()
    model = _port_model()
    b, s0, max_len = 2, 10, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
        .astype(np.int32)
    jcaches = JT.make_caches(cfg, b, max_len, jnp.float32)
    jlog, _, jcaches = JT.forward(params, jnp.asarray(tokens), cfg,
                                  caches=jcaches, backend=backend)
    pcaches = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
    assert tuple(pcaches[0]["k"].shape) == (b, 2, 8, 16)      # local: W rows
    assert tuple(pcaches[1]["k"].shape) == (b, 2, max_len, 16)
    plog, pcaches = PT.forward(model.params, torch.from_numpy(tokens),
                               model.cfg, caches=pcaches)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(p, t, cfg, caches=c,
                                                    index=i, backend=backend))
    for step in range(8):
        index = np.array([s0 + step, s0 + step - 3], np.int32)
        jlog, _, jcaches = jdecode(params, jnp.asarray(tok[:, None]), jcaches,
                                   jnp.asarray(index))
        plog, pcaches = PT.forward(model.params,
                                   torch.from_numpy(tok[:, None]), model.cfg,
                                   caches=pcaches,
                                   index=torch.from_numpy(index))
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


# ---------------------------------------------------------------------------
# kernels: plain versions vs Pallas interpret, gemma2's options
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_softcap_plain_vs_pallas(d, window):
    b, h, h_kv, s = 1, 4, 2, 64
    q, k, v = rnd(1, (b, h, s, d)), rnd(2, (b, h_kv, s, d)), \
        rnd(3, (b, h_kv, s, d))
    kw = dict(causal=True, window=window, softcap=50.0, scale=SCALE)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), backend="interpret", bq=32,
                                bkv=32, **kw)
    got = pops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


@needs_jax
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("sq,window", [(1, None), (1, 12), (3, None)])
def test_paged_softcap_plain_vs_pallas(d, sq, window):
    b, h, h_kv, page, pp = 3, 4, 2, 4, 5
    n_pages = b * pp + 1
    rng = np.random.default_rng(d + sq)
    table = (rng.permutation(n_pages - 1) + 1).reshape(b, pp).astype(np.int32)
    table[2, 3:] = 0                       # past the slot's footprint: sink
    last = np.array([pp * page - 1, 9, 11], np.int32)
    kp, vp = rnd(4, (n_pages, h_kv, page, d)), rnd(5, (n_pages, h_kv, page, d))
    q = rnd(6, (b, h, sq, d))
    kw = dict(window=window, softcap=50.0, scale=SCALE)
    want = jops.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(table),
                                jnp.asarray(last), backend="interpret", **kw)
    got = pops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(table),
                               torch.from_numpy(last), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# engine: greedy tokens against JAX's engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tokens(window=8, speculate=0, **kw):
    cfg, params, _ = _carried(window)
    reg = JRegistry()
    draft = JDraftSpec(bits=8) if speculate else None
    model = reg.load(GEMMA, params=params, draft_spec=draft)
    if window != 8:
        model.cfg = dataclasses.replace(model.cfg, window=window)
        if draft is not None:
            model.draft_cfg = dataclasses.replace(model.draft_cfg,
                                                  window=window)
    eng = JEngine(model, JEngineConfig(n_slots=3, max_len=MAX_LEN,
                                       speculate=speculate, **kw))
    return _run(eng, _jobs(cfg.vocab))


@needs_jax
@pytest.mark.parametrize("k", [1, 4])
def test_slab_engine_matches_jax(k):
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=3, max_len=MAX_LEN, decode_chunk=k, device="cpu"))
    assert eng._len_bounded and eng._bucket_cap == 8
    got = _run(eng, _jobs(256))
    assert got == _jax_tokens(decode_chunk=k)
    assert max(len(p) + g for p, g in _jobs(256)) > 8     # past the window


@needs_jax
@pytest.mark.parametrize("window", [8, 40])
def test_paged_engine_matches_jax(window):
    """Window 8: the local layers keep resident circular leaves and the
    global ones are paged. Window 40 >= max_len: every layer is paged, and
    the local layers attend through the page table under their window. A
    windowed arch shares no prefix either way."""
    eng = InferenceEngine(_port_model(window), EngineConfig(
        n_slots=3, max_len=MAX_LEN, page_size=8, decode_chunk=2,
        device="cpu"))
    paged = eng.pool.layout.paged
    assert [layer["k"] for layer in paged] == \
        ([False, True] * 2 if window == 8 else [True] * 4)
    assert eng.pool.index is None
    got = _run(eng, _jobs(256))
    assert got == _jax_tokens(window, page_size=8, decode_chunk=2)
    slab = InferenceEngine(_port_model(window), EngineConfig(
        n_slots=3, max_len=MAX_LEN, decode_chunk=2, device="cpu"))
    assert got == _run(slab, _jobs(256))


@needs_jax
def test_speculative_refused_on_the_smoke_window():
    model = _port_model(draft_spec=DraftSpec(bits=8))
    with pytest.raises(ValueError, match="window"):
        InferenceEngine(model, EngineConfig(n_slots=3, max_len=MAX_LEN,
                                            speculate=2, device="cpu"))


@needs_jax
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("page_size", [None, 8])
def test_speculative_matches_plain_and_jax(k, page_size):
    """Window 40 >= max_len + K: no cache wraps, so rollback is a clock
    rewind on the local layers too."""
    kw = dict(n_slots=3, max_len=MAX_LEN, device="cpu", page_size=page_size)
    plain = _run(InferenceEngine(_port_model(40), EngineConfig(**kw)),
                 _jobs(256))
    eng = InferenceEngine(_port_model(40, DraftSpec(bits=8)),
                          EngineConfig(speculate=k, **kw))
    got = _run(eng, _jobs(256))
    assert got == plain == _jax_tokens(40, k)
    assert eng.metrics.report()["spec_dispatches"] > 0


@needs_jax
def test_request_past_max_len_refused_as_in_jax():
    """gemma2's global layers have no window, so a request is bounded by
    max_len (the port used to free every windowed arch from the bound)."""
    _, params, _ = _carried()
    jeng = JEngine(JRegistry().load(GEMMA, params=params),
                   JEngineConfig(n_slots=2, max_len=16))
    eng = InferenceEngine(_port_model(), EngineConfig(n_slots=2, max_len=16,
                                                      device="cpu"))
    for e in (jeng, eng):
        e.submit(np.arange(10), 6)                     # exactly max_len
        with pytest.raises(ValueError) as err:
            e.submit(np.arange(12), 5)
        assert "17 cache positions" in str(err.value) \
            and "max_len=16" in str(err.value)
    # a uniformly windowed arch stays unbounded (a circular cache), as in JAX
    danube = ModelRegistry().load("h2o-danube-1.8b", device="cpu")
    InferenceEngine(danube, EngineConfig(n_slots=2, max_len=16,
                                         device="cpu")).submit(np.arange(12),
                                                               5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flash_and_paged_d128_softcap_window(cuda_device):
    """gemma2's attention on the card: flash prefill at d = 128, 4/2 heads,
    softcap 50 and scale 1/12, with and without window 96 at sq 160 (tiles
    wholly behind the window are skipped); paged decode at d = 128 with the
    same options, sq 1 and 5, a second call bitwise equal. f32 at 2e-3."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=gen, device=cuda_device)
    q, k, v = rn(2, 4, 160, 128), rn(2, 2, 160, 128), rn(2, 2, 160, 128)
    for window in (None, 96):
        kw = dict(causal=True, window=window, softcap=50.0, scale=SCALE)
        pops.reset_launch_counts()
        got = pops.flash_attention(q, k, v, **kw)
        assert pops.launch_counts()["flash_attention"] == 1
        want = pref.attention_ref(q, k.repeat_interleave(2, 1),
                                  v.repeat_interleave(2, 1), **kw)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    b, page, pp, h, h_kv = 4, 16, 12, 4, 2
    n_pages = b * pp + 1
    table = (torch.randperm(n_pages - 1, generator=gen, device=cuda_device)
             + 1).reshape(b, pp).to(torch.int32)
    table[3] = 0                                  # an idle slot on the sink
    last = torch.tensor([pp * page - 1, 100, 20, 0], dtype=torch.int32,
                        device=cuda_device)
    kp, vp = rn(n_pages, h_kv, page, 128), rn(n_pages, h_kv, page, 128)
    for sq in (1, 5):
        qd = rn(b, h, sq, 128)
        for window in (None, 64):
            kw = dict(window=window, softcap=50.0, scale=SCALE)
            got = pops.paged_attention(qd, kp, vp, table, last, **kw)
            want = pref.paged_attention_ref(qd, kp, vp, table, last, **kw)
            torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
            assert torch.equal(got, pops.paged_attention(qd, kp, vp, table,
                                                          last, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, 8])
def test_cuda_graph_replay_matches_eager(cuda_device, page_size):
    """The smoke gemma2 (window widened to 40 so the paged form pages every
    layer) served with every decode dispatch a graph replay, against the
    same engine stepping eagerly: greedy tokens equal."""
    out = []
    for eager in (False, True):
        model = ModelRegistry().load(GEMMA, device="cuda")
        model.cfg = dataclasses.replace(model.cfg, window=40)
        eng = InferenceEngine(model, EngineConfig(
            n_slots=3, max_len=MAX_LEN, decode_chunk=2, page_size=page_size))
        if eager:
            eng.backend._graph = None
        out.append(_run(eng, _jobs(256)))
        assert eng.pool.n_active == 0
    assert out[0] == out[1]

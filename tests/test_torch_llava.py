"""Port parity, llava-next-mistral-7b: the Mistral backbone behind the
vision stub.

On the CPU, with numpy inputs from a seed and JAX weights carried across
through `save_pytree` and `checkpoint.convert`:
  * `models.frontends.llava_patches` is bitwise the JAX stub's output;
  * the config and `param_count` (7.24 B) against JAX's;
  * the smoke forward with `img_embeds` prepended (prefill, then decode
    with per-slot clocks past the image rows) against JAX `T.forward`
    under `ref` and Pallas `interpret`, within 1e-4 on the logits;
  * greedy engine tokens with image extras equal JAX's engine on the slab
    and through the page pool, K 1 and 2, among them a prompt whose
    prefill bucket runs past max_len - n_img (the reference's circular
    prefill of a cache windowed on every layer) and, on the slab, a
    request longer than max_len (a cache windowed on every layer is
    unbounded in both; a page pool that pages the window refuses it);
  * prefix reuse is off for the arch (speculative decode of the arch is
    held to JAX's in tests/test_torch_spec_families.py)."""

import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint.manager import save_pytree  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import InferenceEngine as JEngine  # noqa: E402
from repro.serve import ModelRegistry as JRegistry  # noqa: E402

from repro_torch import configs as PC  # noqa: E402
from repro_torch.checkpoint.convert import convert  # noqa: E402
from repro_torch.models import frontends as PF  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import (EngineConfig,  # noqa: E402
                               InferenceEngine, ModelRegistry,
                               prefix_supported)

ARCH = "llava-next-mistral-7b"
N_SLOTS, MAX_LEN = 3, 32
# the smoke window (8) caps every prefill bucket at 8: with the window
# widened past max_len, buckets run to max_len, and prompt 17's bucket
# (32) reaches past max_len - n_img = 24
WIDE = 64
# (prompt length, new tokens): off the pow2 buckets, and 8 + 20 + 9 = 37
# positions, past max_len
JOBS = ((5, 7), (11, 6), (17, 5), (20, 9))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4, err_msg=msg)


def _image(seed, shape):
    return np.random.default_rng(seed).random(shape)


@functools.lru_cache(maxsize=None)
def _carried(window=None):
    cfg = JC.get_smoke(ARCH)
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported


def _port_model(window=None):
    model = ModelRegistry().load(ARCH, params=_carried(window)[2],
                                 device="cpu")
    if window is not None:
        model.cfg = dataclasses.replace(model.cfg, window=window)
    return model


def _img_rows(cfg, seed):
    """(1, n_img_tokens, d) stub rows of a seeded image: the first
    n_img_tokens of llava_patches' 2880 (the smoke config keeps 8)."""
    return PF.llava_patches(_image(seed, (1, 48, 64, 3)), cfg.d_model,
                            device="cpu")[:, :cfg.n_img_tokens].numpy()


@pytest.mark.parametrize("shape", [(2, 336, 336, 3), (1, 75, 101, 3)])
def test_llava_patches_bitwise_jax_stub(shape):
    image = _image(1, shape)
    got = PF.llava_patches(image, 64, device="cpu")
    want = np.asarray(JF.llava_patches(image, 64))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], 2880, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_config_and_param_count_match_jax():
    for get in ("get_config", "get_smoke"):
        want, got = getattr(JC, get)(ARCH), getattr(PC, get)(ARCH)
        jfields = {f.name for f in dataclasses.fields(want)}
        for f in dataclasses.fields(got):
            if f.name in jfields and f.name != "kratos":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.param_count() == want.param_count()
        assert [PT.layer_kind(got, i) for i in range(got.n_layers)] == \
            [JT.layer_kind(want, i) for i in range(want.n_layers)]
    full = PC.get_config(ARCH)
    assert full.param_count() == 7_241_465_856
    assert (full.n_img_tokens, full.frontend, full.window) == \
        (2880, "vision", 4096)


@pytest.mark.parametrize("backend", ["ref", "interpret"])
def test_forward_with_img_embeds_matches_jax(backend):
    """Prefill 8 image rows + 10 tokens, then 4 decode steps with per-slot
    clocks counting the image rows, through the circular window-8 caches,
    against jax.jit of JAX's forward."""
    cfg, params, _ = _carried()
    model = _port_model()
    b, s0, max_len = 2, 10, 40
    n_img = cfg.n_img_tokens
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
        .astype(np.int32)
    img = np.concatenate([_img_rows(cfg, 2), _img_rows(cfg, 3)])
    jprefill = jax.jit(lambda p, t, im, c: JT.forward(
        p, t, cfg, img_embeds=im, caches=c, backend=backend))
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(
        p, t, cfg, caches=c, index=i, backend=backend))
    jc = JT.make_caches(cfg, b, max_len, jnp.float32)
    jlog, _, jc = jprefill(params, jnp.asarray(tokens), jnp.asarray(img), jc)
    pc = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
    plog, pc = PT.forward(model.params, torch.from_numpy(tokens), model.cfg,
                          caches=pc, img_embeds=torch.from_numpy(img))
    assert tuple(plog.shape) == (b, n_img + s0, cfg.vocab)
    _close(plog, jlog, "prefill")
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    for step in range(4):
        index = np.array([n_img + s0 + step, n_img + s0 + step - 3],
                         np.int32)
        jlog, _, jc = jdecode(params, jnp.asarray(tok[:, None]), jc,
                              jnp.asarray(index))
        plog, pc = PT.forward(model.params, torch.from_numpy(tok[:, None]),
                              model.cfg, caches=pc,
                              index=torch.from_numpy(index))
        _close(plog, jlog, f"decode {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


def _run(eng, cfg, jobs, to=np.asarray):
    rng = np.random.default_rng(5)
    reqs = []
    for i, (s0, g) in enumerate(jobs):
        prompt = rng.integers(0, cfg.vocab, s0).astype(np.int32)
        extras = {"img_embeds": to(_img_rows(cfg, 10 + i))}
        reqs.append(eng.submit(prompt, g, arrival_step=i, extras=extras))
    eng.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(window, jobs, **kw):
    cfg, params, _ = _carried(window)
    model = JRegistry().load(ARCH, params=params)
    model.cfg = cfg
    eng = JEngine(model, JEngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                       **kw))
    return _run(eng, cfg, jobs), eng._len_bounded


@pytest.mark.parametrize("window,k,page_size", [
    (None, 1, None), (None, 2, 8), (WIDE, 1, None), (WIDE, 2, 8)])
def test_engine_with_images_matches_jax(window, k, page_size, monkeypatch):
    """Greedy tokens with image extras equal JAX's engine, slab and paged.
    The prefill batch carries the image rows, the sampled row sits at
    n_img + s0 - 1 of a padded bucket, the decode clock starts at
    n_img + s0, and the pages cover n_img + s0 + budget positions. With the
    window widened, prompt 17 prefills in a bucket of 32, past
    max_len - n_img."""
    model = _port_model(window)
    cfg = model.cfg
    eng = InferenceEngine(model, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=k,
        page_size=page_size, device="cpu"))
    prefill = eng.backend.prefill
    seen = []
    monkeypatch.setattr(eng.backend, "prefill", lambda batch, exact: (
        seen.append((batch["tokens"].shape[1],
                     tuple(batch["img_embeds"].shape))),
        prefill(batch, exact))[1])
    start = eng._start
    indices = []
    monkeypatch.setattr(eng, "_start", lambda r: (start(r), indices.append(
        (len(r.prompt), r.index)))[0])
    # a circular cache (the slab's, or a window-8 leaf the pool keeps
    # resident) serves past max_len as JAX's does; a paged window ends at
    # max_len (JAX's paged engine clamps its table lookup past it)
    paged_window = page_size is not None and window == WIDE
    assert eng._len_bounded == paged_window
    jobs = JOBS[:-1] if paged_window else JOBS
    want, bounded = _jax_tokens(window, jobs, decode_chunk=k,
                                page_size=page_size)
    got = _run(eng, cfg, jobs, to=torch.from_numpy)
    assert got == want
    assert not bounded
    if paged_window:
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.zeros(20, np.int32), 9, extras={
                "img_embeds": torch.from_numpy(_img_rows(cfg, 0))})
    n_img = cfg.n_img_tokens
    assert all(img == (1, n_img, cfg.d_model) for _, img in seen)
    assert indices == [(s0, n_img + s0) for s0, _ in jobs]
    buckets = [s for s, _ in seen]
    if window == WIDE:
        assert buckets == [16, 16, 32, 32][:len(jobs)]
        assert n_img + buckets[2] > MAX_LEN
    else:
        assert buckets == [s0 for s0, _ in jobs]     # the window caps them
    if page_size:
        assert eng.pool.index is None
        assert eng.metrics.report()["prefill_tokens_skipped"] == 0


def test_prefix_reuse_off():
    cfg = PC.get_smoke(ARCH)
    assert not prefix_supported(cfg)
    # the image rows alone turn it off, window or not
    assert not prefix_supported(dataclasses.replace(cfg, window=None))
    assert prefix_supported(dataclasses.replace(
        cfg, window=None, frontend=None, n_img_tokens=0))
    eng = InferenceEngine(_port_model(WIDE), EngineConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8, device="cpu"))
    assert eng.pool.index is None

"""Port parity, whisper-large-v3: the encoder-decoder behind the audio stub.

On the CPU, with numpy inputs from a seed and JAX weights carried across
through `save_pytree` and `checkpoint.convert`:
  * `models.frontends.whisper_frames` is bitwise the JAX stub's output;
  * the config and `param_count` (1.744 B: the reference counts an encoder
    MLP as 3 d d_ff though it is not gated) against JAX's, and the
    decoder's position table against JAX's `_sinusoidal_positions`;
  * `convert` carries every encoder and cross-attention key;
  * `encode`, then the forward's prefill (reading the encoder output, its
    cross k/v written into the caches) and decode with per-slot clocks
    (reading them back), against jax.jit of JAX's `T.encode` and
    `T.forward` under `ref` and Pallas `interpret`, dense and s0.5-w8,
    within 1e-4;
  * the packed projections (the encoder's and the cross-attention's
    among them) count and weigh as in JAX's registry;
  * greedy engine tokens with frame extras equal JAX's engine on the slab
    and through the page pool (page 8), K 1 and 2, every prompt prefilled
    at its exact length;
  * the cross leaves stay slot-major and resident in a page pool, also
    when max_len equals enc_positions; prefix reuse is off (speculative
    decode of the arch is held to JAX's in
    tests/test_torch_spec_families.py);
  * the port's `gelu` is `jax.nn.gelu`'s tanh form."""

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
from repro.core import kratos as jkr  # noqa: E402
from repro.models import frontends as JF  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import InferenceEngine as JEngine  # noqa: E402
from repro.serve import ModelRegistry as JRegistry  # noqa: E402

from repro_torch import configs as PC  # noqa: E402
from repro_torch.checkpoint.convert import convert  # noqa: E402
from repro_torch.core import kratos as pkr  # noqa: E402
from repro_torch.models import frontends as PF  # noqa: E402
from repro_torch.models import layers as PL  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve import (EngineConfig,  # noqa: E402
                               InferenceEngine, ModelRegistry,
                               prefix_supported)

ARCH = "whisper-large-v3"
SPECS = {"dense": {}, "s0.5w8": dict(sparsity=0.5, bits=8, bk=8, bn=8)}
N_SLOTS, MAX_LEN = 3, 32
# (prompt length, new tokens): lengths off every pow2 bucket
JOBS = ((5, 7), (11, 6), (17, 5), (9, 8))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4, err_msg=msg)


def _frames(cfg, seed, batch=1):
    """(batch, enc_positions, d) stub frames of a seeded 1 s waveform at
    16 kHz: the first enc_positions of whisper_frames' 1500."""
    wave = np.random.default_rng(seed).standard_normal((batch, 16000))
    return PF.whisper_frames(wave, cfg.d_model, device="cpu")[
        :, :cfg.enc_positions].numpy()


@functools.lru_cache(maxsize=None)
def _carried(name="dense"):
    cfg = JC.get_smoke(ARCH, kratos=jkr.KratosSpec(**SPECS[name]))
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        with np.load(f"{d}/arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        ported = convert(d, cfg.n_layers)
    return cfg, params, ported, flat


def _port_model(name="dense"):
    return ModelRegistry().load(ARCH, pkr.KratosSpec(**SPECS[name]),
                                params=_carried(name)[2], device="cpu")


def test_gelu_is_jax_default_tanh_form():
    x = np.random.default_rng(0).uniform(-8.0, 8.0, 1 << 16) \
        .astype(np.float32)
    got = PL.ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    # the erf form is what the published model uses; the reference is not
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(x))).max() > 1e-4


@pytest.mark.parametrize("shape", [(2, 480000), (1, 16123)])
def test_whisper_frames_bitwise_jax_stub(shape):
    wave = np.random.default_rng(1).standard_normal(shape)
    got = PF.whisper_frames(wave, 64, device="cpu")
    want = np.asarray(JF.whisper_frames(wave, 64))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], 1500, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_config_param_count_and_positions_match_jax():
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
    assert full.param_count() == 1_744_110_080
    assert (full.enc_dec, full.n_enc_layers, full.enc_positions,
            full.frontend, full.use_rope, full.gated) == \
        (True, 32, 1500, "audio", False, False)
    # the jitted reference's table, to within one f32 ulp of its values
    d = PC.get_smoke(ARCH).d_model
    want = np.asarray(jax.jit(
        lambda: JT._sinusoidal_positions(PT.DEC_POSITIONS, d))())
    np.testing.assert_allclose(PT.position_table(d, "cpu").numpy(), want,
                               rtol=0, atol=6e-8)


def test_convert_carries_encoder_and_cross_keys():
    """Every key save_pytree writes lands in the port's tree unchanged:
    `blocks/#0/...` (cross and cross_norm among them) row t in layer t,
    `enc_blocks/...` row t in enc_layers[t], `enc_norm` beside them."""
    cfg, _, ported, flat = _carried()
    assert {"blocks/#0/cross/wq/w", "blocks/#0/cross_norm/scale",
            "enc_blocks/mixer/wk/w", "enc_blocks/ffn/w_up/w",
            "enc_blocks/ffn_norm/bias", "enc_norm/scale"} <= set(flat)
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] in ("blocks", "enc_blocks"):
            layers = ported["layers" if parts[0] == "blocks"
                            else "enc_layers"]
            path = parts[2:] if parts[0] == "blocks" else parts[1:]
            assert len(layers) == arr.shape[0] == 2
            for t, layer in enumerate(layers):
                for p in path:
                    layer = layer[p]
                np.testing.assert_array_equal(layer.numpy(), arr[t], key)
        else:
            node = ported
            for p in parts:
                node = node[p]
            np.testing.assert_array_equal(node.numpy(), arr, key)
    enc = ported["enc_layers"][0]
    assert set(enc) == {"pre_norm", "mixer", "ffn_norm", "ffn"}
    assert set(enc["ffn"]) == {"w_up", "w_down"}            # not gated
    assert {"cross", "cross_norm"} <= set(ported["layers"][1])


@pytest.mark.parametrize("backend,name", [("ref", "dense"),
                                          ("interpret", "dense"),
                                          ("ref", "s0.5w8"),
                                          ("interpret", "s0.5w8")])
def test_encode_and_forward_match_jax(backend, name):
    """The encoder over two requests' frames, the prefill of 10 tokens
    reading its output, then 4 decode steps with per-slot clocks reading
    the cross caches back, against jax.jit of JAX's encode and forward."""
    cfg, params, _, _ = _carried(name)
    model = _port_model(name)
    b, s0, max_len = 2, 10, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (b, s0)) \
        .astype(np.int32)
    frames = np.concatenate([_frames(cfg, 2), _frames(cfg, 3)])
    jenc = jax.jit(lambda p, f: JT.encode(p, f, cfg, backend=backend))
    jprefill = jax.jit(lambda p, t, e, c: JT.forward(
        p, t, cfg, enc_out=e, caches=c, backend=backend))
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(
        p, t, cfg, caches=c, index=i, backend=backend))
    jenc_out = jenc(params, jnp.asarray(frames))
    penc_out = PT.encode(model.params, _t(frames), model.cfg)
    _close(penc_out, jenc_out, f"{name} encode")
    jc = JT.make_caches(cfg, b, max_len, jnp.float32)
    jlog, _, jc = jprefill(params, jnp.asarray(tokens), jenc_out, jc)
    pc = PT.make_caches(model.cfg, b, max_len, torch.float32, "cpu")
    assert set(pc[0]) == {"k", "v", "cross_k", "cross_v"}
    assert tuple(pc[0]["cross_k"].shape) == (b, 4, cfg.enc_positions, 16)
    plog, pc = PT.forward(model.params, _t(tokens), model.cfg, caches=pc,
                          enc_out=penc_out)
    _close(plog, jlog, f"{name} prefill")
    for li in range(cfg.n_layers):
        _close(pc[li]["cross_k"], jc["blocks"][0]["cross"]["k"][li],
               f"{name} cross k, layer {li}")
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    for step in range(4):
        index = np.array([s0 + step, s0 + step - 3], np.int32)
        jlog, _, jc = jdecode(params, jnp.asarray(tok[:, None]), jc,
                              jnp.asarray(index))
        plog, pc = PT.forward(model.params, _t(tok[:, None]), model.cfg,
                              caches=pc, index=_t(index))
        _close(plog, jlog, f"{name} decode {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


@pytest.mark.parametrize("name", list(SPECS))
def test_packed_projections_follow_jax_registry(name):
    """The JAX registry packs each stacked leaf once (a (layers, n, p)
    stack of the decoder's self- and cross-attention and MLP, and the
    encoder's attention and MLP); the port packs each layer's, and counts
    them as the JAX package does: the same count, bytes and dense
    bytes."""
    cfg, params, _, _ = _carried(name)
    jm = JRegistry().load(ARCH, jkr.KratosSpec(**SPECS[name]), params=params)
    model = _port_model(name)
    assert cfg.n_layers == cfg.n_enc_layers == 2
    assert jm.n_packed == (4 + 4 + 2) + (4 + 2)
    assert model.n_packed == jm.n_packed
    assert (model.packed_bytes, model.dense_bytes) == \
        (jm.packed_bytes, jm.dense_bytes)
    kinds = {type(model.params["layers"][0]["cross"]["wq"]),
             type(model.params["enc_layers"][1]["ffn"]["w_down"])}
    assert kinds == {pkr.PackedLinear}


def _run(eng, cfg, to=np.asarray, jobs=JOBS):
    rng = np.random.default_rng(5)
    reqs = []
    for i, (s0, g) in enumerate(jobs):
        prompt = rng.integers(0, cfg.vocab, s0).astype(np.int32)
        extras = {"frames": to(_frames(cfg, 10 + i))}
        reqs.append(eng.submit(prompt, g, arrival_step=i, extras=extras))
    eng.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_tokens(**kw):
    cfg, params, _, _ = _carried()
    eng = JEngine(JRegistry().load(ARCH, params=params),
                  JEngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN, **kw))
    return _run(eng, cfg)


@pytest.mark.parametrize("k,page_size", [(1, None), (2, None), (1, 8),
                                         (2, 8)])
def test_engine_with_frames_matches_jax(k, page_size, monkeypatch):
    """Greedy tokens with frame extras equal JAX's engine, slab and paged:
    each admission carries its frames into the prefill batch, prefills at
    the prompt's exact length, and the decode clock starts at the prompt's
    end."""
    model = _port_model()
    cfg = model.cfg
    eng = InferenceEngine(model, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, decode_chunk=k,
        page_size=page_size, device="cpu"))
    assert eng._exact_prefill and eng._len_bounded
    prefill = eng.backend.prefill
    seen = []
    monkeypatch.setattr(eng.backend, "prefill", lambda batch, exact: (
        seen.append((batch["tokens"].shape[1], exact,
                     tuple(batch["frames"].shape))),
        prefill(batch, exact))[1])
    got = _run(eng, cfg, to=torch.from_numpy)
    assert got == _jax_tokens(decode_chunk=k, page_size=page_size)
    assert seen == [(s0, True, (1, cfg.enc_positions, cfg.d_model))
                    for s0, _ in JOBS]
    if page_size:
        assert eng.pool.index is None
        assert eng.metrics.report()["prefill_tokens_skipped"] == 0


def test_cross_leaves_resident_when_max_len_is_enc_positions():
    """At max_len == enc_positions a cross leaf has the shape of a paged
    one; by name it stays slot-major and resident, written whole at
    admission, and the pool's tokens equal the slab's."""
    model = _port_model()
    cfg = model.cfg
    max_len = cfg.enc_positions
    jobs = ((5, 7), (11, 6), (9, 8))
    tokens = {}
    for page_size in (None, 8):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=max_len, decode_chunk=2,
            page_size=page_size, device="cpu"))
        if page_size:
            layout = eng.pool.layout
            assert layout.paged == [{"k": True, "v": True, "cross_k": False,
                                     "cross_v": False}] * cfg.n_layers
            assert tuple(eng.pool.store[0]["cross_k"].shape) == \
                (N_SLOTS, cfg.n_kv_heads, max_len, cfg.dh)
            assert tuple(eng.pool.store[0]["k"].shape) == \
                (eng.pool.n_pages, cfg.n_kv_heads, 8, cfg.dh)
        tokens[page_size] = _run(eng, cfg, to=torch.from_numpy, jobs=jobs)
    assert tokens[8] == tokens[None]


def test_prefix_reuse_off():
    cfg = PC.get_smoke(ARCH)
    assert not prefix_supported(cfg)
    # the encoder's conditioning alone turns it off, frontend or not
    assert not prefix_supported(dataclasses.replace(cfg, frontend=None))
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=2, max_len=MAX_LEN, page_size=8, device="cpu"))
    assert eng.pool.index is None


def test_request_past_max_len_refused_as_in_jax():
    """The decoder's cache is positional: bounded by max_len in both."""
    eng = InferenceEngine(_port_model(), EngineConfig(
        n_slots=2, max_len=MAX_LEN, device="cpu"))
    jeng = JEngine(JRegistry().load(ARCH, params=_carried()[1]),
                   JEngineConfig(n_slots=2, max_len=MAX_LEN))
    prompt = np.arange(20, dtype=np.int32)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="max_len"):
            e.submit(prompt, MAX_LEN - 19)
        e.submit(prompt, MAX_LEN - 20)

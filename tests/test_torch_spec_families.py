"""Port parity, speculative self-draft decode of the MoE, hybrid, vision and
audio archs (deepseek-moe-16b, deepseek-v2-lite-16b, jamba-v0.1-52b,
llava-next-mistral-7b, whisper-large-v3), and the host-side decode loop.

On the CPU, at the smoke configs, with JAX weights carried across by
`checkpoint.convert`:
  * engine: greedy speculative tokens (K 1, 2, 4, w8 draft) equal JAX's
    speculating engine, and plain tokens equal JAX's plain engine, for
    deepseek-moe at its smoke capacity 2.0 (where, as in JAX, the block
    verify parts from plain decode: each slot's K+1 positions route as a
    group of their own) and at 4.0 (= n_experts / top_k: nothing drops,
    speculative equals plain), deepseek-v2-lite at 4.0, jamba at 2.0 (=
    n_experts / top_k) and 1.0 (K+1 single-token verify steps; where
    they drop, the other slots' draft tokens share each step's routing
    group, and JAX's speculating engine parts from plain decode too),
    llava with its window off (image rows in both prefills; the smoke
    window of 8 is refused) and whisper on the slab and through the page
    pool (frames through each model's own encoder);
  * the draft artifact: a bits-only draft shares the target's raw expert
    stacks (the same storage), a block-sparse tree draft freezes its own;
    whisper's draft packs its own encoder and shares the position table;
    `keep_layers` keeps the prelude and whole scan periods, with JAX's
    message; llava's image rows and whisper's frames reach the draft's
    prefill, whose slab holds the draft's own cross k/v;
  * the host loop (`device_loop=False`): greedy and sampled tokens
    (temperature 0.8, Gumbel noise from numpy's generator) equal JAX's
    host loop, 3 host syncs a decode step, greedy tokens equal the device
    loop's at K 1 (the engine clock admits at the same steps); the JAX
    engine's validation errors.
`cuda`-marked tests hold the speculative dispatch's CUDA graph to its
eager step for deepseek-moe (slab and paged) and jamba, and the host loop's
graphed forward to the device loop, on the card."""

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
    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry

from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.models import moe as PM
from repro_torch.serve import (CachePool, DraftSpec, EngineConfig,
                               InferenceEngine, ModelRegistry)

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
DEEPSEEK, LITE, JAMBA = ("deepseek-moe-16b", "deepseek-v2-lite-16b",
                         "jamba-v0.1-52b")
LLAVA, WHISPER, NEMOTRON, FALCON = ("llava-next-mistral-7b",
                                    "whisper-large-v3", "nemotron-4-340b",
                                    "falcon-mamba-7b")
# (prompt length, new tokens): mixed lengths, staggered arrivals
JOBS = ((5, 7), (9, 4), (7, 6))
N_SLOTS, MAX_LEN = 4, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extras(cfg, seed):
    """A request's model inputs besides its tokens, numpy from a seed: the
    vision stub's image rows, or the audio stub's frames."""
    rng = np.random.default_rng(seed)
    if cfg.n_img_tokens:
        return {"img_embeds": rng.standard_normal(
            (1, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.enc_dec:
        return {"frames": rng.standard_normal(
            (1, cfg.enc_positions, cfg.d_model)).astype(np.float32)}
    return None


def _run(eng, jobs=JOBS, seed=11, **submit_kw):
    cfg = eng.model.cfg
    rng = np.random.default_rng(seed)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, s0).astype(np.int32), g,
                       arrival_step=i, extras=_extras(cfg, 100 + i),
                       **submit_kw)
            for i, (s0, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX params, the port's dense params) on the same weights."""
    cfg = JC.get_smoke(arch)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return params, ported


def _adjust(model, capacity_factor):
    """Both packages' artifacts the same way: the capacity factor set (None
    keeps the smoke's) and llava's window off (its smoke window of 8 makes
    the cache circular, which speculation refuses), on target and draft."""
    changes = {}
    if capacity_factor is not None:
        changes["capacity_factor"] = capacity_factor
    if model.cfg.name.startswith("llava"):
        changes["window"] = None
    model.cfg = dataclasses.replace(model.cfg, **changes)
    if model.draft_cfg is not None:
        model.draft_cfg = dataclasses.replace(model.draft_cfg, **changes)
    return model


@functools.lru_cache(maxsize=None)
def _jax_model(arch, capacity_factor=None):
    params, _ = _carried(arch)
    return _adjust(JRegistry().load(arch, params=params,
                                    draft_spec=JDraftSpec(bits=8)),
                   capacity_factor)


@functools.lru_cache(maxsize=None)
def _port_model(arch, capacity_factor=None):
    _, ported = _carried(arch)
    return _adjust(ModelRegistry().load(arch, params=ported, device="cpu",
                                        draft_spec=DraftSpec(bits=8)),
                   capacity_factor)


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, capacity_factor, k, page_size=None):
    """JAX's greedy tokens: speculating with K = k, or plain (k = 0)."""
    eng = JEngine(_jax_model(arch, capacity_factor), JEngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, speculate=k, page_size=page_size))
    return _run(eng)


@functools.lru_cache(maxsize=None)
def _port_plain(arch, capacity_factor, page_size=None):
    return _run(InferenceEngine(_port_model(arch, capacity_factor),
                                EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                             page_size=page_size,
                                             device="cpu")))


# (arch, capacity factor (None: the smoke's), page size, whether JAX's
# speculating engine parts from its plain one): deepseek-moe's smoke 2.0
# drops assignments, which a block verify routes differently; jamba at 1.0
# drops too, and its verify steps, though they route all slots as one
# group as plain decode does, route the other slots' draft tokens with it
CASES = [(DEEPSEEK, None, None, True), (DEEPSEEK, 4.0, None, False),
         (LITE, 4.0, None, False), (JAMBA, None, None, False),
         (JAMBA, 1.0, None, True), (LLAVA, None, None, False),
         (WHISPER, None, None, False), (WHISPER, None, 8, False)]


# ---------------------------------------------------------------------------
# engine: greedy tokens against JAX's speculating engine and plain decode
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch,capacity_factor,page_size,parts", CASES)
def test_greedy_tokens_match_jax(arch, capacity_factor, page_size, parts, k):
    eng = InferenceEngine(_port_model(arch, capacity_factor), EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, speculate=k, page_size=page_size,
        device="cpu"))
    got = _run(eng)
    want = _jax_tokens(arch, capacity_factor, k, page_size)
    plain = _port_plain(arch, capacity_factor, page_size)
    assert got == want
    assert plain == _jax_tokens(arch, capacity_factor, 0, page_size)
    # the reference's fact: where plain decode drops assignments a block
    # verify routes apart from it; elsewhere speculation is plain decode
    assert (want != plain) == parts
    rep = eng.metrics.report()
    assert rep["host_syncs_decode"] == rep["decode_steps"] \
        == rep["spec_dispatches"] > 0
    # one verify block a cycle, or K+1 single-token steps on the hybrid
    n_target = k + 1 if arch == JAMBA else 1
    assert eng._verify_steps == n_target
    assert rep["micro_steps"] == rep["decode_steps"] * (k + 1 + n_target)
    if page_size:
        assert isinstance(eng.backend.draft_pool, CachePool)


@needs_jax
def test_llava_smoke_window_refused_as_in_jax():
    """The smoke window (8) is below max_len + K: circular, refused."""
    params, ported = _carried(LLAVA)
    jm = JRegistry().load(LLAVA, params=params, draft_spec=JDraftSpec(bits=8))
    pm = ModelRegistry().load(LLAVA, params=ported, device="cpu",
                              draft_spec=DraftSpec(bits=8))
    assert pm.cfg.window == jm.cfg.window == 8
    with pytest.raises(ValueError, match="window"):
        JEngine(jm, JEngineConfig(n_slots=2, max_len=MAX_LEN, speculate=2))
    with pytest.raises(ValueError, match="window"):
        InferenceEngine(pm, EngineConfig(n_slots=2, max_len=MAX_LEN,
                                         speculate=2, device="cpu"))


# ---------------------------------------------------------------------------
# the draft artifact
# ---------------------------------------------------------------------------

def _moe_layers(model):
    return [i for i, layer in enumerate(model.params["layers"])
            if "router" in layer.get("ffn", {})]


@pytest.mark.parametrize("arch", [DEEPSEEK, JAMBA])
def test_bits_only_draft_shares_the_expert_stacks(arch):
    """Under a bits-only draft spec the routed stacks stay raw floats, so
    the draft's are the dense target's own storage; a tree draft with a
    block plan freezes its own block-sparse stacks."""
    reg = ModelRegistry()
    m = reg.load(arch, device="cpu", draft_spec=DraftSpec(bits=8))
    layers = _moe_layers(m)
    assert layers
    for i in layers:
        for name in PM.EXPERT_STACKS:
            t = m.params["layers"][i]["ffn"][name]
            d = m.draft_params["layers"][i]["ffn"][name]
            assert isinstance(t, torch.Tensor) and isinstance(d, torch.Tensor)
            assert d.data_ptr() == t.data_ptr(), (i, name)
        # the mixer's projections are the draft's own, at w8
        for name, lin in m.draft_params["layers"][i]["mixer"].items():
            if isinstance(lin, pkr.PackedLinear):
                assert lin.spec.bits == 8, name
                assert m.params["layers"][i]["mixer"][name].spec.bits is None
    sparse = reg.load(arch, device="cpu", draft_spec=DraftSpec(
        bits=8, sparsity=0.5, bk=8, bn=8))
    for i in layers:
        for name in PM.EXPERT_STACKS:
            assert isinstance(sparse.draft_params["layers"][i]["ffn"][name],
                              pkr.PackedExperts)
            assert isinstance(sparse.params["layers"][i]["ffn"][name],
                              torch.Tensor)


def test_whisper_draft_packs_its_encoder_and_shares_positions():
    m = ModelRegistry().load(WHISPER, device="cpu",
                             draft_spec=DraftSpec(bits=8, sparsity=0.5,
                                                  bk=8, bn=8))
    assert m.draft_params["pos_table"] is m.params["pos_table"]
    assert m.draft_params["embed"]["emb"] is m.params["embed"]["emb"]
    assert len(m.draft_params["enc_layers"]) == m.cfg.n_enc_layers
    for tree, spec in ((m.params, m.cfg.kratos),
                       (m.draft_params, m.draft_cfg.kratos)):
        for layer in tree["enc_layers"]:
            assert layer["mixer"]["wq"].spec == spec
            assert layer["ffn"]["w_up"].spec == spec
    assert m.draft_cfg.kratos.bits == 8 and m.cfg.kratos.bits is None


@needs_jax
@pytest.mark.parametrize("arch,keep", [(JAMBA, 4), (DEEPSEEK, 1)])
def test_keep_layers_refused_as_in_jax(arch, keep):
    """A cut must keep the dense prelude and whole scan periods (a Jamba
    block of 8); both packages say so in the same words."""
    msg = r"must keep the \d+-layer prelude plus a whole number of scan " \
        r"periods"
    with pytest.raises(ValueError, match=msg) as jerr:
        JRegistry().load(arch, draft_spec=JDraftSpec(bits=8,
                                                     keep_layers=keep))
    with pytest.raises(ValueError, match=msg) as perr:
        ModelRegistry().load(arch, device="cpu", draft_spec=DraftSpec(
            bits=8, keep_layers=keep))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("arch,keep", [(JAMBA, 8), (DEEPSEEK, 2)])
def test_keep_layers_served(arch, keep):
    m = ModelRegistry().load(arch, device="cpu",
                             draft_spec=DraftSpec(bits=8, keep_layers=keep))
    assert m.draft_cfg.n_layers == keep == len(m.draft_params["layers"])
    for i in range(keep):
        assert m.draft_params["layers"][i]["pre_norm"]["scale"] is \
            m.params["layers"][i]["pre_norm"]["scale"]
    eng = InferenceEngine(m, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                          speculate=2, device="cpu"))
    got = _run(eng)
    assert [len(t) for t in got] == [g for _, g in JOBS]
    assert eng.metrics.report()["spec_dispatches"] > 0


@pytest.mark.parametrize("arch", [LLAVA, WHISPER])
def test_extras_reach_the_draft_prefill(arch, monkeypatch):
    """The draft's batch-1 prefill takes the admission's whole batch: the
    image rows (the draft's clock counts them, as the target's) or the
    frames (encoded by the draft's own encoder into the draft's slab)."""
    m = ModelRegistry().load(arch, device="cpu",
                             draft_spec=DraftSpec(bits=8))
    if arch == LLAVA:
        m.cfg = dataclasses.replace(m.cfg, window=None)
        m.draft_cfg = dataclasses.replace(m.draft_cfg, window=None)
    eng = InferenceEngine(m, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                          speculate=2, device="cpu"))
    bk = eng.backend
    draft_prefill = bk._draft_prefill
    seen = []
    monkeypatch.setattr(bk, "_draft_prefill", lambda params, batch: (
        seen.append({k: tuple(v.shape) for k, v in batch.items()}),
        draft_prefill(params, batch))[1])
    cfg = m.cfg
    prompt = np.arange(6, dtype=np.int32)
    extras = _extras(cfg, 3)
    r = eng.submit(prompt, 1, extras=extras)
    eng.step()
    key, = (k for k in extras)
    assert seen == [{"tokens": (1, eng._prefill_len(6)),
                     key: extras[key].shape}]
    slot = r.slot
    dcache = bk.draft_pool.caches
    if arch == LLAVA:
        # the image rows and the prompt fill the draft's first n_img + 6
        # positions, as an exact-length prefill of both fills them
        from repro_torch.models import transformer as T
        n = cfg.n_img_tokens + 6
        assert r.index == n
        one = T.make_caches(m.draft_cfg, 1, MAX_LEN + 2, torch.float32,
                            "cpu")
        T.forward(m.draft_params, torch.from_numpy(prompt[None]),
                  m.draft_cfg, caches=one,
                  img_embeds=torch.from_numpy(extras["img_embeds"]))
        for li, layer in enumerate(dcache):
            torch.testing.assert_close(layer["k"][slot][:, :n],
                                       one[li]["k"][0][:, :n])
    else:
        enc = torch.from_numpy(extras["frames"])
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as T
        want = A._split_heads(pkr.apply(
            m.draft_params["layers"][0]["cross"]["wk"],
            T.encode(m.draft_params, enc, m.draft_cfg)), cfg.n_kv_heads,
            cfg.dh)[0]
        torch.testing.assert_close(dcache[0]["cross_k"][slot], want)
        assert not torch.equal(dcache[0]["cross_k"][slot],
                               eng.pool.caches[0]["cross_k"][slot])


# ---------------------------------------------------------------------------
# the host loop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_host_tokens(arch, temperature):
    params, _ = _carried(arch)
    eng = JEngine(JRegistry().load(arch, params=params), JEngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, device_loop=False, seed=3))
    return _run(eng, temperature=temperature), eng.metrics.report()


@needs_jax
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", [NEMOTRON, FALCON, DEEPSEEK, WHISPER])
def test_host_loop_matches_jax(arch, temperature):
    """`device_loop=False`: one (B, 1) forward a step, the logits pulled,
    sampled on the host from numpy's generator seeded as JAX's, the token
    and index vectors uploaded: the same tokens as JAX's host loop, greedy
    and sampled, at 3 host syncs a decode step."""
    _, ported = _carried(arch)
    model = ModelRegistry().load(arch, params=ported, device="cpu")
    eng = InferenceEngine(model, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, device_loop=False, seed=3,
        device="cpu"))
    got = _run(eng, temperature=temperature)
    want, jrep = _jax_host_tokens(arch, temperature)
    assert got == want
    rep = eng.metrics.report()
    assert rep["host_syncs_decode"] == 3 * rep["decode_steps"] > 0
    assert rep["host_syncs_prefill"] == len(JOBS)
    for key in ("decode_steps", "micro_steps", "host_syncs_decode",
                "host_syncs_per_token", "tokens_generated"):
        assert rep[key] == jrep[key], key
    if temperature == 0.0:
        # K 1: a K-step dispatch advances the engine clock by K, which
        # moves the staggered admissions (and an MoE step's routing group)
        device = InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu"))
        assert _run(device) == got
        drep = device.metrics.report()
        assert drep["host_syncs_decode"] == drep["decode_steps"]
        assert drep["host_syncs_per_token"] < rep["host_syncs_per_token"]
    else:
        assert got != _run(InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, device_loop=False, seed=4,
            device="cpu")), temperature=temperature)


def test_host_loop_validation():
    """The JAX engine's refusals: every fused-dispatch feature requires the
    device loop."""
    for kw, what in ((dict(decode_chunk=2), "decode_chunk > 1"),
                     (dict(page_size=8), "page_size"),
                     (dict(speculate=2), "speculate"),
                     (dict(ledger=object()), "ledger")):
        with pytest.raises(ValueError,
                           match=f"{what} requires device_loop=True"):
            EngineConfig(device_loop=False, device="cpu", **kw)
    eng = InferenceEngine(ModelRegistry().load(NEMOTRON, device="cpu"),
                          EngineConfig(device_loop=False, device="cpu"))
    with pytest.raises(RuntimeError, match="decode_host"):
        eng.backend.decode_block()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("arch,page_size", [(DEEPSEEK, None), (DEEPSEEK, 8),
                                            (JAMBA, None)])
def test_cuda_spec_graph_matches_eager(cuda_device, arch, page_size):
    """The speculative cycle of an MoE and of the hybrid arch captured as
    one CUDA graph (routing, sort and the recurrent snapshots inside it)
    gives the eager step's tokens, greedy and sampled."""
    model = ModelRegistry().load(arch, device="cuda",
                                 draft_spec=DraftSpec(bits=8))
    out = []
    for eager in (False, True):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, speculate=2,
            page_size=page_size))
        assert eng.backend._graph is not None
        if eager:
            eng.backend.spec_decode_block = functools.partial(
                eng.backend.spec_decode_block, eager=True)
        out.append((_run(eng), _run(eng, seed=12, temperature=0.7)))
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [NEMOTRON, DEEPSEEK])
def test_cuda_host_loop_matches_device_loop(cuda_device, arch):
    """The host loop's graphed (B, 1) forward, its eager form, and the
    device loop give the same greedy tokens on the card."""
    model = ModelRegistry().load(arch, device="cuda")
    host = InferenceEngine(model, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, device_loop=False))
    assert host.backend._graph is not None
    got = _run(host)
    eager = InferenceEngine(model, EngineConfig(
        n_slots=N_SLOTS, max_len=MAX_LEN, device_loop=False))
    eager.backend.decode_host = functools.partial(eager.backend.decode_host,
                                                  eager=True)
    device = InferenceEngine(model, EngineConfig(n_slots=N_SLOTS,
                                                 max_len=MAX_LEN))
    assert got == _run(eager) == _run(device)
    rep = host.metrics.report()
    assert rep["host_syncs_decode"] == 3 * rep["decode_steps"]

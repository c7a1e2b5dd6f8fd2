"""Port parity, Mamba: the plain version of `ssm_scan` against the JAX
Pallas kernel in interpret mode and against its sequential oracle;
`mamba_apply` against the JAX package's `ref` path on the same weights
(full sequence, prefill caches, a decode step, a prompt shorter than the
conv tail); the falcon-mamba smoke forward (prefill and decode logits);
and greedy engine tokens equal JAX's `InferenceEngine` for the dense and
the sparse x int8 spec at K in {1, 4}, on the slab and through the page
pool, with prompts of lengths that no pow2 bucket fits and a request that
runs past max_len. Also: the pool keeps the recurrent leaves resident by
name and refuses prefix reuse over them. The CUDA kernel itself is held to
the plain version on the card (`cuda` marker; `python3 chip_smoke.py`
runs the full-width cases)."""

import dataclasses
import functools

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
    from repro.core import kratos as jkr
    from repro.kernels import ops as jops
    from repro.kernels.ssm_scan import ssm_scan_ref as jssm_ref
    from repro.models import ssm as JS
    from repro.models import transformer as JT
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry
    from repro.serve.registry import pack_model_params as jpack

    from test_torch_serve import _record_decode_host_reads

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.serve import (EngineConfig, InferenceEngine, ModelRegistry,
                               PageLayout, prefix_supported)
from repro_torch.serve.registry import pack_model_params

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
ARCH = "falcon-mamba-7b"
SPECS = {"dense": {}, "s0.5w8": dict(sparsity=0.5, bits=8, bk=8, bn=8)}
MAX_LEN = 32
# (prompt length, new tokens, arrival step): lengths off every pow2 bucket
# and below the conv tail (2), staggered arrivals, and 9 + 30 positions,
# past max_len (a pure SSM's state does not grow)
TRACE = [(5, 7, 0), (11, 3, 0), (2, 12, 1), (9, 30, 2), (6, 5, 6)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread than
    spread over many (and the suite runs several workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_spec(name):
    return jkr.KratosSpec(**SPECS[name])


def port_spec(s):
    return pkr.KratosSpec(sparsity=s.sparsity, bits=s.bits, bk=s.bk,
                          bn=s.bn, act_bits=s.act_bits, seed=s.seed)


def scan_inputs(seed, bsz, s, di, st):
    """The inputs of tests/test_ssm_kernel.py's laws, drawn with numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    u = n(bsz, s, di) * 0.5
    dt = np.log1p(np.exp(n(bsz, s, di) - 1.0)).astype(np.float32)
    b, c = n(bsz, s, st) * 0.5, n(bsz, s, st) * 0.5
    a = -np.exp(n(di, st) * 0.3).astype(np.float32)
    return u, dt, b, c, a


# ---------------------------------------------------------------------------
# kernel: plain version vs Pallas interpret and vs the sequential oracle
# ---------------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("bsz,s,di,st,bd,ck,dtype", [
    (1, 16, 8, 4, 8, 4, "float32"),
    (2, 32, 16, 4, 8, 8, "float32"),
    (2, 24, 16, 8, 16, 4, "float32"),
    (1, 16, 8, 4, 8, 4, "bfloat16"),
])
def test_ssm_scan_plain_vs_pallas(bsz, s, di, st, bd, ck, dtype):
    u, dt, b, c, a = scan_inputs(0, bsz, s, di, st)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = lambda x: jnp.asarray(x).astype(jd)
    want_y, want_h = jops.ssm_scan(j(u), j(dt), j(b), j(c), jnp.asarray(a),
                                   backend="interpret", bd=bd, ck=ck)
    t = lambda x: torch.from_numpy(x).to(td)
    got_y, got_h = pops.ssm_scan(t(u), t(dt), t(b), t(c), torch.from_numpy(a))
    assert got_y.dtype == td and got_h.dtype == torch.float32
    # bf16: the JAX test's tolerance (both sides run an f32 state on the
    # same bf16 inputs and round y to bf16)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=tol,
                               atol=tol)


@needs_jax
@pytest.mark.parametrize("s", [7, 1])
def test_ssm_scan_plain_vs_jax_oracle(s):
    """Lengths the Pallas kernel's chunking does not take (the port's
    kernel takes any S >= 1)."""
    u, dt, b, c, a = scan_inputs(1, 2, s, 24, 8)
    want_y, want_h = jssm_ref(*map(jnp.asarray, (u, dt, b, c, a)))
    got_y, got_h = pops.ssm_scan(*map(torch.from_numpy, (u, dt, b, c, a)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssm_scan_matches_plain_version(cuda_device, dtype):
    """The kernel against its plain version on the card: 1-token and
    ragged lengths, a d_inner off the CTA's channel count, d_state 16, 8
    and 5; falcon-mamba's d_inner 8192 at lengths within, at and across
    the kernel's staged 32-position blocks (1, 31, 64, 65, 512) and a
    narrow d_inner at 512 positions. A second call is bitwise equal."""
    td = getattr(torch, dtype)
    tol = (1e-4, 1e-4) if dtype == "float32" else (3e-2, 3e-2)
    for bsz, s, di, st in ((1, 1, 256, 16), (2, 33, 128, 8), (1, 130, 72, 5),
                           (1, 1, 8192, 16), (1, 31, 8192, 16),
                           (1, 64, 8192, 16), (1, 65, 8192, 16),
                           (1, 512, 8192, 16), (1, 512, 512, 16)):
        u, dt, b, c, a = (torch.from_numpy(x).to(cuda_device)
                          for x in scan_inputs(2, bsz, s, di, st))
        args = [x.to(td) for x in (u, dt, b, c)] + [a]
        pops.reset_launch_counts()
        y, h = pops.ssm_scan(*args)
        assert pops.launch_counts()["ssm_scan"] == 1
        want_y, want_h = pref.ssm_scan_ref(*args)
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol[0],
                                   rtol=tol[1])
        torch.testing.assert_close(h, want_h, atol=tol[0], rtol=tol[1])
        y2, h2 = pops.ssm_scan(*args)
        assert torch.equal(y, y2) and torch.equal(h, h2)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# mixer and model against the JAX package
# ---------------------------------------------------------------------------

def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@needs_jax
@pytest.mark.parametrize("s", [12, 2])
def test_mamba_apply_matches_jax(s):
    """Full sequence without a cache, prefill into a cache (conv tail and
    final state; s = 2 is shorter than the 3-row tail), then one decode
    step from that cache."""
    jcfg = JS.MambaConfig(d_model=64, d_inner=128, d_state=8, d_conv=4,
                          bcdt_rms=True, chunk=8)
    pcfg = PS.MambaConfig(d_model=64, d_inner=128, d_state=8, d_conv=4,
                          bcdt_rms=True)
    jp = JS.mamba_init(jax.random.PRNGKey(0), jcfg)
    pp, n_packed = pack_model_params(to_torch(jp), pkr.DENSE)
    assert n_packed == 3
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-4,
                              atol=1e-4)

    jy, _ = JS.mamba_apply(jp, jnp.asarray(x), jcfg)
    py, _ = PS.mamba_apply(pp, torch.from_numpy(x), pcfg)
    close(py.numpy(), np.asarray(jy))

    jc = JS.make_mamba_cache(jcfg, 2)
    jy, jc = JS.mamba_apply(jp, jnp.asarray(x), jcfg, cache=jc)
    pc = PS.make_mamba_cache(pcfg, 2, device="cpu")
    py, pc = PS.mamba_apply(pp, torch.from_numpy(x), pcfg, cache=pc)
    close(py.numpy(), np.asarray(jy))
    for name in ("conv", "ssm"):
        close(pc[name].numpy(), np.asarray(jc[name]), err_msg=name)

    index = np.full((2,), s, np.int32)
    jy, jc = JS.mamba_apply(jp, jnp.asarray(x1), jcfg, cache=jc,
                            index=jnp.asarray(index))
    py, pc = PS.mamba_apply(pp, torch.from_numpy(x1), pcfg, cache=pc,
                            index=torch.from_numpy(index))
    close(py.numpy(), np.asarray(jy))
    for name in ("conv", "ssm"):
        close(pc[name].numpy(), np.asarray(jc[name]), err_msg=name)


@needs_jax
def test_falcon_config_matches_jax():
    """The published and smoke configs, field for field where both
    packages have the field."""
    for get in ("get_config", "get_smoke"):
        want, got = getattr(JC, get)(ARCH), getattr(PC, get)(ARCH)
        jfields = {f.name for f in dataclasses.fields(want)}
        for f in dataclasses.fields(got):
            if f.name in jfields and f.name != "kratos":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.d_inner == want.d_inner
    assert PC.get_config(ARCH).d_inner == 8192


def carried(spec, path):
    """(JAX cfg, JAX flat params, JAX packed params, port model) on the
    same weights."""
    cfg = JC.get_smoke(ARCH, kratos=spec)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    save_pytree(str(path), params)
    model = ModelRegistry().load(ARCH, port_spec(spec),
                                 params=convert(str(path), cfg.n_layers),
                                 device="cpu")
    return cfg, params, jpack(params, spec)[0], model


@needs_jax
def test_convert_carries_the_mamba_tree(tmp_path):
    _, params, _, model = carried(jax_spec("dense"), tmp_path)
    ported = convert(str(tmp_path), 4)
    mixer = params["blocks"][0]["mixer"]
    for i in range(4):
        got = ported["layers"][i]["mixer"]
        for name in ("conv_w", "A_log", "D"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(mixer[name][i]))
        np.testing.assert_array_equal(got["dt_proj"]["b"].numpy(),
                                      np.asarray(mixer["dt_proj"]["b"][i]))
        np.testing.assert_array_equal(got["c_norm"]["scale"].numpy(),
                                      np.asarray(mixer["c_norm"]["scale"][i]))
        assert set(ported["layers"][i]) == {"pre_norm", "mixer"}
    # in/x/out once for the stacked layers (the JAX package's count);
    # dt_proj stays
    assert model.n_packed == 3


@needs_jax
@pytest.mark.parametrize("name", list(SPECS))
def test_falcon_prefill_and_decode_logits_match_jax(name, tmp_path):
    cfg, _, jparams, model = carried(jax_spec(name), tmp_path)
    bsz, s0, steps = 2, 10, 4
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (bsz, s0)) \
        .astype(np.int32)
    jcaches = JT.make_caches(cfg, bsz, MAX_LEN, jnp.float32)
    jlog, _, jcaches = JT.forward(jparams, jnp.asarray(tokens), cfg,
                                  caches=jcaches)
    pcaches = PT.make_caches(model.cfg, bsz, MAX_LEN, torch.float32, "cpu")
    plog, pcaches = PT.forward(model.params, torch.from_numpy(tokens),
                               model.cfg, caches=pcaches)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(p, t, cfg, caches=c,
                                                    index=i))
    for step in range(steps):
        index = np.full((bsz,), s0 + step, np.int32)
        jlog, _, jcaches = jdecode(jparams, jnp.asarray(tok[:, None]),
                                   jcaches, jnp.asarray(index))
        plog, pcaches = PT.forward(model.params,
                                   torch.from_numpy(tok[:, None]), model.cfg,
                                   caches=pcaches,
                                   index=torch.from_numpy(index))
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)


# ---------------------------------------------------------------------------
# engine: greedy tokens against JAX's, slab and paged
# ---------------------------------------------------------------------------

def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, s0).astype(np.int32)
            for s0, _, _ in TRACE]


def _run(engine, prompts):
    reqs = [engine.submit(p, g, arrival_step=a)
            for p, (_, g, a) in zip(prompts, TRACE)]
    engine.run()
    return [list(r.generated) for r in reqs]


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX greedy tokens, JAX params) for one spec."""
    spec = jax_spec(name)
    cfg = JC.get_smoke(ARCH, kratos=spec)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    model = JRegistry().load(ARCH, spec, params=params)
    eng = JEngine(model, JEngineConfig(n_slots=3, max_len=MAX_LEN))
    return _run(eng, _prompts(cfg.vocab)), params


def _port_model(name, tmp_path):
    want, params = _jax_side(name)
    save_pytree(str(tmp_path), params)
    model = ModelRegistry().load(ARCH, port_spec(jax_spec(name)),
                                 params=convert(str(tmp_path), 4),
                                 device="cpu")
    return want, model


@needs_jax
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", list(SPECS))
def test_falcon_greedy_tokens_match_jax_engine(name, k, tmp_path,
                                               monkeypatch):
    want, model = _port_model(name, tmp_path)
    eng = InferenceEngine(model, EngineConfig(n_slots=3, max_len=MAX_LEN,
                                              decode_chunk=k, device="cpu"))
    admitted = []
    start = eng._start
    monkeypatch.setattr(eng, "_start", lambda r: (admitted.append(r),
                                                  start(r))[1])
    prefill = eng.backend.prefill
    lengths = []
    monkeypatch.setattr(eng.backend, "prefill", lambda batch, exact: (
        lengths.append((batch["tokens"].shape[1], exact)),
        prefill(batch, exact))[1])
    reads = _record_decode_host_reads(monkeypatch, eng.backend)
    got = _run(eng, _prompts(model.cfg.vocab))
    monkeypatch.undo()
    assert got == want
    # exact-length prefill: no pad token enters the recurrence
    assert lengths == [(len(r.prompt), True) for r in admitted]
    rep = eng.metrics.report()
    assert reads == ["cpu"] * int(rep["decode_steps"])
    assert rep["requests_completed"] == len(TRACE)


@needs_jax
def test_paged_falcon_engine_serves_the_slab_tokens(tmp_path):
    """Through the page pool (page_size 16) the recurrent leaves stay
    resident, no page is allocated and no prefix is shared; the tokens
    equal the slab's (and JAX's)."""
    want, model = _port_model("s0.5w8", tmp_path)
    eng = InferenceEngine(model, EngineConfig(
        n_slots=3, max_len=MAX_LEN, decode_chunk=2, device="cpu",
        page_size=16))
    assert eng.backend.paged and eng.pool.index is None
    assert not eng.pool.layout.has_paged
    got = _run(eng, _prompts(model.cfg.vocab))
    assert got == want
    rep = eng.metrics.report()
    assert rep["pages_in_use"] == 0 and rep["prefill_tokens_skipped"] == 0


def test_recurrent_leaves_stay_resident_by_name():
    """At max_len == d_inner (128) the (B, d_inner, d_state) `ssm` leaf has
    the shape of a positional leaf; the layout keeps it (and `conv`)
    resident by name, and prefix reuse is off for the arch."""
    cfg = PC.get_smoke(ARCH)
    assert cfg.d_inner == 128
    layout = PageLayout(cfg, 2, cfg.d_inner, 16, device="cpu")
    assert layout.slab_shapes[0]["ssm"] == (2, 128, 8)
    assert all(not paged for layer in layout.paged for paged in layer.values())
    assert not layout.has_paged
    assert layout.store_shapes(5) == layout.slab_shapes
    assert not prefix_supported(cfg)
    assert prefix_supported(PC.get_smoke("nemotron-4-340b"))

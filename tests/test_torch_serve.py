"""Port parity, serving: greedy tokens of `repro_torch`'s InferenceEngine
equal `repro`'s on one mixed-length trace, for the dense and the
sparse x int8 spec, at decode chunks K in {1, 4}, with exactly one
tensor-to-host read per decode dispatch. Also: the port imports nothing of JAX or
`repro`, and its entry points refuse a missing GPU and unported features
(the paged engine's parity is in test_torch_paging.py)."""

import ast
import functools
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as JC
from repro.checkpoint.manager import save_pytree
from repro.core import kratos as jkr
from repro.models import transformer as JT
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import InferenceEngine as JEngine
from repro.serve import ModelRegistry as JRegistry
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.serve import (EngineConfig, EngineSaturated,
                               InferenceEngine, ModelRegistry)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "h2o-danube-1.8b"
SPECS = {"dense": jkr.KratosSpec(),
         "s0.5w8": jkr.KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)}
# (prompt length, new tokens, arrival step): mixed lengths, staggered
# arrivals, generation past the smoke config's 8-token window
TRACE = [(5, 7, 0), (11, 3, 0), (8, 12, 1), (3, 9, 2), (6, 5, 6)]


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, s0).astype(np.int32)
            for s0, _, _ in TRACE]


def _run(engine, prompts):
    reqs = [engine.submit(p, g, arrival_step=a)
            for p, (_, g, a) in zip(prompts, TRACE)]
    engine.run()
    return [list(r.generated) for r in reqs]


_HOST_READS = ("cpu", "item", "tolist", "__int__", "__float__", "__bool__",
               "__index__")


def _record_decode_host_reads(monkeypatch, backend):
    """Record every tensor-to-host read made inside a decode dispatch."""
    reads, active = [], [False]
    for name in _HOST_READS:
        def wrapped(self, *a, _orig=getattr(torch.Tensor, name), _name=name,
                    **kw):
            if active[0]:
                reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    decode_block = backend.decode_block

    def counted():
        active[0] = True
        try:
            return decode_block()
        finally:
            active[0] = False
    monkeypatch.setattr(backend, "decode_block", counted)
    return reads


@functools.lru_cache(maxsize=None)
def _jax_side(name):
    """(JAX greedy tokens, flat JAX params) for one spec."""
    spec = SPECS[name]
    cfg = JC.get_smoke(ARCH, kratos=spec)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    model = JRegistry().load(ARCH, spec, params=params)
    eng = JEngine(model, JEngineConfig(n_slots=3, max_len=32))
    return _run(eng, _prompts(cfg.vocab)), params


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", list(SPECS))
def test_greedy_tokens_match_jax_engine(name, k, tmp_path, monkeypatch):
    want, params = _jax_side(name)
    save_pytree(str(tmp_path), params)
    s = SPECS[name]
    cfg = JC.get_smoke(ARCH)
    model = ModelRegistry().load(
        ARCH, pkr.KratosSpec(sparsity=s.sparsity, bits=s.bits, bk=s.bk,
                             bn=s.bn),
        params=convert(str(tmp_path), cfg.n_layers), device="cpu")
    eng = InferenceEngine(model, EngineConfig(n_slots=3, max_len=32,
                                              decode_chunk=k, device="cpu"))
    reads = _record_decode_host_reads(monkeypatch, eng.backend)
    got = _run(eng, _prompts(cfg.vocab))
    monkeypatch.undo()
    assert got == want
    rep = eng.metrics.report()
    # one host read per dispatch: the (K, B) token block, nothing inside
    # the K micro-steps
    assert reads == ["cpu"] * int(rep["decode_steps"])
    assert rep["host_syncs_decode"] == rep["decode_steps"] > 0
    assert rep["host_syncs_prefill"] == len(TRACE)
    assert rep["requests_completed"] == len(TRACE)


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)


def test_cuda_device_refused_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelRegistry().load(ARCH)
    model = ModelRegistry().load(ARCH, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, EngineConfig())


@pytest.mark.parametrize("field,value,item", [
    ("qos", object(), "item 8"), ("paged_native", False, "item 10"),
    ("pool_wait_retries", 2, "item 8"), ("ledger", object(), "item 8"),
    ("device_loop", False, "item 8"), ("trace", object(), "item 8")])
def test_unported_engine_features_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        EngineConfig(device="cpu", **{field: value})


def test_unported_specs_and_archs_refused_up_front():
    """Every KratosSpec packs now (w, qt, blocks, qblocks); an unported
    arch and the training-time apply on a dense leaf still raise."""
    reg = ModelRegistry()
    for spec in (pkr.KratosSpec(bits=4), pkr.KratosSpec(bits=8, act_bits=8),
                 pkr.KratosSpec(sparsity=0.5, bits=8, act_bits=8, bk=8,
                                bn=8)):
        assert reg.load(ARCH, spec, device="cpu").n_packed > 0
    with pytest.raises(NotImplementedError, match="item 7"):
        reg.load("jamba-v0.1-52b", device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        pkr.apply({"w": torch.zeros(4, 4)}, torch.zeros(1, 4))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "deepseek-v2-lite-16b"])
def test_convert_carries_moe_keys(arch):
    """An MoE checkpoint as save_pytree writes it: the dense prelude
    layer, then the stacked MoE layers with `ffn/router/w`, the raw routed
    stacks `ffn/w_gate` (layer axis first, no `/w` suffix) and the shared
    experts `ffn/shared/<proj>/w`; each lands in its layer unchanged."""
    cfg = JC.get_smoke(arch)
    params = JT.init(jax.random.PRNGKey(2), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        with np.load(f"{d}/arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        ported = convert(d, cfg.n_layers)
    assert "blocks/#0/ffn/router/w" in flat
    assert flat["blocks/#0/ffn/w_gate"].shape == (2, 8, 64, 32)
    assert "blocks/#0/ffn/shared/w_down/w" in flat
    assert "prelude/#0/ffn/w_up/w" in flat
    layers = ported["layers"]
    assert set(layers[0]["ffn"]) == {"w_gate", "w_up", "w_down"}
    for li in (1, 2):
        ffn = layers[li]["ffn"]
        assert set(ffn) == {"router", "w_gate", "w_up", "w_down", "shared"}
        for name in ("w_gate", "w_up", "w_down"):
            assert np.array_equal(ffn[name].numpy(),
                                  flat[f"blocks/#0/ffn/{name}"][li - 1])
            assert np.array_equal(
                ffn["shared"][name]["w"].numpy(),
                flat[f"blocks/#0/ffn/shared/{name}/w"][li - 1])
        assert np.array_equal(ffn["router"]["w"].numpy(),
                              flat["blocks/#0/ffn/router/w"][li - 1])


@pytest.mark.parametrize("key", ["blocks/#0/ffn/router/b",
                                 "blocks/#0/ffn/shared/w_proj/w",
                                 "blocks/#0/cross/wq/w"])
def test_convert_refuses_unported_layer_keys(key):
    flat = dict(_flat_smoke("deepseek-moe-16b"))
    flat[key] = np.zeros((2, 4), np.float32)
    with pytest.raises(NotImplementedError, match="item 7"):
        convert(flat, 3)


def test_convert_refuses_the_jamba_hybrid():
    """jamba's layers mix Mamba mixers (`in_proj`, `conv_w`, ...) with
    attention mixers and MoE FFNs: every key is a ported name, and the mix
    is refused."""
    cfg = JC.get_smoke("jamba-v0.1-52b")
    flat = _flat_smoke("jamba-v0.1-52b")
    assert any("/mixer/in_proj/w" in k for k in flat)
    assert any("/mixer/wq/w" in k for k in flat)
    with pytest.raises(NotImplementedError, match="jamba hybrid.*item 7"):
        convert(flat, cfg.n_layers)


@functools.lru_cache(maxsize=None)
def _flat_smoke_cached(arch):
    params = JT.init(jax.random.PRNGKey(0), JC.get_smoke(arch))
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        with np.load(f"{d}/arrays.npz") as z:
            return tuple((k, z[k]) for k in z.files)


def _flat_smoke(arch):
    return dict(_flat_smoke_cached(arch))


def test_bounded_waiting_rejects():
    model = ModelRegistry().load(ARCH, device="cpu")
    eng = InferenceEngine(model, EngineConfig(n_slots=1, max_len=24,
                                              max_waiting=1, device="cpu"))
    eng.submit(np.arange(4), 2)
    with pytest.raises(EngineSaturated):
        eng.submit(np.arange(4), 2)
    eng.run()
    assert eng.metrics.report()["rejected"] == 1

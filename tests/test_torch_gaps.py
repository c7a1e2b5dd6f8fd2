"""Port parity, four public members the examples need that the port
lacked, each against the JAX package: `CachePool.bytes()` (the slab's
bytes), `ModelRegistry.names()`, `RequestRecord.submit_time` (the wall
clock at submit, a log anchor no latency reads) through the metrics
payloads both ways, and `MoEConfig.router_norm_topk=False` (the raw top-k
weights)."""

import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.core import kratos as jkr
from repro.models import moe as JM
from repro.serve import ModelRegistry as JRegistry
from repro.serve.cache_pool import CachePool as JPool
from repro.serve.metrics import ServeMetrics as JMetrics
from repro_torch import configs as PC
from repro_torch.core import kratos as pkr
from repro_torch.models import moe as PM
from repro_torch.serve import ModelRegistry
from repro_torch.serve.cache_pool import CachePool
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import pack_model_params


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "falcon-mamba-7b"])
def test_cache_pool_bytes_match_jax(arch):
    want = JPool(JC.get_smoke(arch), 4, 64).bytes()
    got = CachePool(PC.get_smoke(arch), 4, 64, device="cpu").bytes()
    assert got == want > 0


def test_registry_names_match_jax():
    spec = dict(sparsity=0.5, bits=8, bk=8, bn=8)
    jreg, reg = JRegistry(), ModelRegistry()
    for arch, s in (("h2o-danube-1.8b", spec), ("falcon-mamba-7b", None)):
        jreg.load(arch, jkr.KratosSpec(**s) if s else None)
        reg.load(arch, pkr.KratosSpec(**s) if s else None, device="cpu")
    assert reg.names() == jreg.names() == sorted(reg.names())
    assert len(reg.names()) == 2


def _served_metrics(cls):
    """Metrics of one request through submit, start, two tokens and its
    finish; (metrics, wall clock just before and after the submit)."""
    m = cls()
    before = time.time()
    m.on_submit(7, 3, 12)
    after = time.time()
    m.on_start(7, 4)
    m.on_token(7, 4)
    m.on_token(7, 5)
    m.on_finish(7, 5)
    return m, before, after


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_submit_time_crosses_the_payload(direction):
    src, dst = ((ServeMetrics, JMetrics) if direction == "port_to_jax"
                else (JMetrics, ServeMetrics))
    m, before, after = _served_metrics(src)
    rec = m.records[7]
    assert before <= rec.submit_time <= after
    back = dst.from_payload(json.loads(json.dumps(m.to_payload())))
    got = back.records[7]
    assert got.submit_time == rec.submit_time
    assert got.submit_mono == 0.0           # the sender's monotonic clock
    assert (got.first_token_step, got.finish_step, got.n_generated) \
        == (rec.first_token_step, rec.finish_step, rec.n_generated)
    # no latency figure reads the wall anchor
    lat = [k for k in m.report() if k.startswith(("latency", "ttft"))]
    assert lat
    figures = [{k: m.report()[k] for k in lat}]
    rec.submit_time = 0.0
    figures.append({k: m.report()[k] for k in lat})
    assert figures[0] == figures[1]


def test_router_norm_topk_off_matches_jax():
    kw = dict(d_model=64, n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
              capacity_factor=64.0, router_norm_topk=False)
    jcfg, pcfg = JM.MoEConfig(**kw), PM.MoEConfig(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(0), jcfg)
    pp = pack_model_params(
        {"ffn": jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), jp)},
        pkr.KratosSpec())[0]["ffn"]
    x = np.random.default_rng(1).standard_normal((3, 10, 64)) \
        .astype(np.float32)
    want, _ = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    got = PM.moe_apply(pp, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        PM.moe_ref(pp, torch.from_numpy(x), pcfg).numpy(),
        np.asarray(JM.moe_ref(jp, jnp.asarray(x), jcfg)), rtol=1e-4,
        atol=1e-4)
    # the raw top-k weights: not the renormalised ones the default takes
    normed = PM.moe_apply(pp, torch.from_numpy(x), dataclasses.replace(
        pcfg, router_norm_topk=True))
    assert not torch.allclose(normed, got, atol=1e-3)

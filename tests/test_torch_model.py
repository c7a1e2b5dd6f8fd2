"""Port parity, model: prefill and decode logits of the nemotron and
h2o-danube smoke configs, `repro_torch` against `repro`'s `T.forward`, on
JAX weights carried across by `repro_torch.checkpoint.convert` and packed
by each package's own registry code. Decode runs past h2o-danube's
8-token window, through the circular cache."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.checkpoint.manager import save_pytree
from repro.core import kratos as jkr
from repro.models import transformer as JT
from repro.serve.registry import pack_model_params as jpack
from repro_torch.checkpoint.convert import convert
from repro_torch.core import kratos as pkr
from repro_torch.models import transformer as PT
from repro_torch.serve import ModelRegistry

SPECS = [jkr.KratosSpec(), jkr.KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)]
B, S0, STEPS, MAX_LEN = 2, 10, 12, 32


def port_spec(s):
    return pkr.KratosSpec(sparsity=s.sparsity, bits=s.bits, impl=s.impl,
                          bk=s.bk, bn=s.bn, act_bits=s.act_bits, seed=s.seed)


def carried(arch, spec, path):
    """(JAX cfg, JAX packed params, port model) on the same weights."""
    cfg = JC.get_smoke(arch, kratos=spec)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    save_pytree(str(path), params)
    model = ModelRegistry().load(arch, port_spec(spec),
                                 params=convert(str(path), cfg.n_layers),
                                 device="cpu")
    return cfg, jpack(params, spec)[0], model


@pytest.mark.parametrize("spec", SPECS, ids=["dense", "s0.5w8"])
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "h2o-danube-1.8b"])
def test_prefill_and_decode_logits_match_jax(arch, spec, tmp_path):
    cfg, jparams, model = carried(arch, spec, tmp_path)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S0)) \
        .astype(np.int32)
    jcaches = JT.make_caches(cfg, B, MAX_LEN, jnp.float32)
    jlog, _, jcaches = JT.forward(jparams, jnp.asarray(tokens), cfg,
                                  caches=jcaches)
    pcaches = PT.make_caches(model.cfg, B, MAX_LEN, torch.float32, "cpu")
    plog, pcaches = PT.forward(model.params, torch.from_numpy(tokens),
                               model.cfg, caches=pcaches)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.forward(p, t, cfg, caches=c,
                                                    index=i))
    for step in range(STEPS):
        index = np.full((B,), S0 + step, np.int32)
        jlog, _, jcaches = jdecode(jparams, jnp.asarray(tok[:, None]),
                                   jcaches, jnp.asarray(index))
        plog, pcaches = PT.forward(model.params, torch.from_numpy(tok[:, None]),
                                   model.cfg, caches=pcaches,
                                   index=torch.from_numpy(index))
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {step}")
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
        assert (plog[:, -1].argmax(-1).numpy() == tok).all()


def test_convert_unstacks_layers(tmp_path):
    cfg = JC.get_smoke("h2o-danube-1.8b")
    params = JT.init(jax.random.PRNGKey(1), cfg)
    save_pytree(str(tmp_path), params)
    ported = convert(str(tmp_path), cfg.n_layers)
    assert len(ported["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            ported["layers"][i]["mixer"]["wq"]["w"].numpy(),
            np.asarray(params["blocks"][0]["mixer"]["wq"]["w"][i]))
    np.testing.assert_array_equal(ported["head"]["w"].numpy(),
                                  np.asarray(params["head"]["w"]))

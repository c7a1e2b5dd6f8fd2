"""Port parity, core: quantization codes, block plans, packed buffers and
apply_packed of `repro_torch.core` against `repro.core` on the same numpy
inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import kratos as jkr
from repro.core import quantize as jqz
from repro.core import sparsity as jsp
from repro_torch.core import kratos as pkr
from repro_torch.core import quantize as pqz
from repro_torch.core import sparsity as psp


def _w(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_pack_codes_and_quantize_byte_identical(bits):
    w = _w(bits, (64, 24))
    jq = jqz.quantize(jnp.asarray(w), bits)
    pq = pqz.quantize(torch.from_numpy(w), bits)
    assert pq.data.dtype == torch.int8 and pq.shape == jq.shape
    np.testing.assert_array_equal(pq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_allclose(pq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-6)
    # pack_codes alone, on every code value the width can hold
    lo = -1 if bits == 1 else -jqz.QMAX[bits]
    codes = np.random.default_rng(7).integers(lo, jqz.QMAX[bits] + 1,
                                              (32, 5)).astype(np.int8)
    if bits == 1:
        codes = np.where(codes >= 0, 1, -1).astype(np.int8)
    packed = pqz.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jqz.pack_codes(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(pqz.unpack_codes(packed, bits).numpy(),
                                  codes)


@pytest.mark.parametrize("n_in,n_out,bk,bn,sparsity,seed", [
    (64, 48, 8, 8, 0.3, 3), (64, 32, 16, 16, 0.75, 9),
    (2560, 6912, 128, 128, 0.5, 0), (6912, 2560, 128, 128, 0.75, 0)])
def test_make_plan_indices_identical(n_in, n_out, bk, bn, sparsity, seed):
    jp = jsp.make_plan(n_in, n_out, bk=bk, bn=bn, sparsity=sparsity, seed=seed)
    pp = psp.make_plan(n_in, n_out, bk=bk, bn=bn, sparsity=sparsity, seed=seed)
    assert pp.nnz == jp.nnz
    np.testing.assert_array_equal(pp.indices, jp.indices)
    np.testing.assert_array_equal(psp.plan_mask(pp), jsp.plan_mask(jp))


SPECS = [
    jkr.KratosSpec(),
    jkr.KratosSpec(sparsity=0.5, bk=8, bn=8),
    jkr.KratosSpec(sparsity=0.5, bk=8, bn=8, impl="systolic"),
    jkr.KratosSpec(sparsity=0.75, bits=8, bk=8, bn=8),
    jkr.KratosSpec(sparsity=0.5, bits=4, bk=8, bn=8),
    jkr.KratosSpec(sparsity=0.5, bits=8, bk=16, bn=16),
    jkr.KratosSpec(sparsity=0.75, bits=4, bk=16, bn=16),
]


def _port_spec(s):
    return pkr.KratosSpec(sparsity=s.sparsity, bits=s.bits, impl=s.impl,
                          bk=s.bk, bn=s.bn, seed=s.seed)


def _ids(s):
    return f"s{s.sparsity}b{s.bits}{s.impl[0]}{s.bk}"


@pytest.mark.parametrize("spec", SPECS, ids=_ids)
def test_pack_buffers_byte_identical_and_apply_packed(spec):
    params = jkr.init(jax.random.PRNGKey(42), 64, 32, spec)
    w = np.array(params["w"])
    jbuf = jkr.pack(params, spec)
    plin = pkr.pack_linear({"w": torch.from_numpy(w)}, _port_spec(spec))
    assert set(plin.buffers) == set(jbuf)
    for k, v in jbuf.items():
        got = plin.buffers[k].numpy()
        assert got.dtype == np.asarray(v).dtype and got.shape == v.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(v).view(np.uint8))
    plan = jkr.plan_for(64, 32, spec)
    if plin.indices is not None:
        assert plin.indices.dtype == torch.int32
        np.testing.assert_array_equal(plin.indices.numpy(), plan.indices)
    x = _w(1, (8, 64), 1.0)
    want = jkr.apply_packed(jbuf, jnp.asarray(x), spec, 64, 32)
    got = pkr.apply_packed(plin, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_unported_specs_raise():
    """The weight-only and w8a8 specs pack into the buffers JAX's pack()
    makes ('qt' dense, 'qblocks' on the tree path, where act_bits is not
    used); the training-time apply on a dense leaf raises outside the
    training step's reference path (tests/test_torch_train.py holds it to
    JAX's inside)."""
    w = {"w": torch.zeros(64, 32)}
    assert set(pkr.pack_linear(w, pkr.KratosSpec(bits=8)).buffers) == {"qt"}
    assert set(pkr.pack_linear(w, pkr.KratosSpec(bits=8, act_bits=8))
               .buffers) == {"qt"}
    assert set(pkr.pack_linear(w, pkr.KratosSpec(
        sparsity=0.5, bits=8, act_bits=8, bk=8, bn=8)).buffers) \
        == {"qblocks", "qscale"}
    with pytest.raises(RuntimeError, match="reference path"):
        pkr.apply(w, torch.zeros(2, 64))


def test_cost_report_matches_jax():
    for s in SPECS:
        assert pkr.cost_report(2560, 6912, _port_spec(s), m=8) == \
            jkr.cost_report(2560, 6912, s, m=8)

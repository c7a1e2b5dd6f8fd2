"""Port parity, the sharding rules (no process group): the port's
`distributed.sharding` spec functions and `steps.decode_state_pspecs`
against the JAX package's on a (data=4, model=2) and a (pod=2, data=2,
model=2) abstract mesh, leaf for leaf — every arch's smoke parameters
carried across by `checkpoint/convert.py`, slab and lock-step caches at a
slot count that divides the data axes and one that does not, page stores
of the three paged families — and `launch.mesh`'s `parse_mesh_arg` and
`plan_fleet_topology`, their errors included. The port's trees are per
layer: a JAX leaf stacked over a scan slot's layers (or the encoder's)
stands for each of those layers, its spec less the leading None."""

import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec as JP  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.checkpoint import manager as JM  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.distributed import steps as JST  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.paging import PageLayout as JLayout  # noqa: E402

from repro_torch import configs as PC  # noqa: E402
from repro_torch.checkpoint import convert as CV  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.serve.paging import PageLayout  # noqa: E402

MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PAGED = ["nemotron_4_340b", "jamba_v0_1_52b", "minicpm3_4b"]


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), SH.AbstractMesh(shape, axes)


def _flat(tree):
    """A JAX spec tree as {checkpoint path: spec}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(JM._key_str(k) for k in kp): v for kp, v in leaves}


def _port_paths(key, cfg, layers="layers"):
    """(port path, stacked) for each port leaf a JAX leaf stands for."""
    top, *rest = key.split("/")
    n0, period = cfg.prelude_layers, cfg.scan_period
    if top == "prelude":
        return [(f"{layers}/{rest[0]}/" + "/".join(rest[1:]), False)]
    if top == "blocks":
        s = int(rest[0][1:])
        n_t = (cfg.n_layers - n0) // period
        return [(f"{layers}/#{n0 + t * period + s}/" + "/".join(rest[1:]),
                 True) for t in range(n_t)]
    if top == "enc_blocks":
        return [(f"enc_layers/#{t}/" + "/".join(rest), True)
                for t in range(cfg.n_enc_layers)]
    return [(key, False)]


def _assert_same(jspecs, pspecs, cfg, layers="layers"):
    """Every JAX spec equals the port's for each leaf it stands for, and
    the port has no other leaf."""
    seen = set()
    for key, jspec in jspecs.items():
        for path, stacked in _port_paths(key, cfg, layers):
            want = tuple(jspec)[1:] if stacked else tuple(jspec)
            assert tuple(pspecs[path]) == want, (key, path, pspecs[path])
            seen.add(path)
    assert seen == set(pspecs), sorted(set(pspecs) ^ seen)


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX smoke params, the port's, carried through a save_pytree): zeros
    of the init's shapes, as the specs read only shapes."""
    cfg = JC.get_smoke(arch)
    shapes = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), cfg))
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    with tempfile.TemporaryDirectory() as d:
        JM.save_pytree(d, params)
        return params, CV.convert(d, cfg.n_layers)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_param_pspecs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg = JC.get_smoke(arch)
    params, ported = _carried(arch)
    _assert_same(_flat(JSH.param_pspecs(params, jmesh)),
                 SH.param_pspecs(ported, pmesh), cfg)
    # without a mesh: the raw name rules
    _assert_same(_flat(JSH.param_pspecs(params)), SH.param_pspecs(ported),
                 cfg)


def _cache_paths(caches):
    """The port's cache list as {path: spec-or-leaf} with JAX's names
    (layer/#i/mixer/<leaf>, layer/#i/cross/k|v)."""
    out = {}
    for i, layer in enumerate(caches):
        for name, v in layer.items():
            if name.startswith("cross_"):
                out[f"layers/#{i}/cross/{name[len('cross_'):]}"] = v
            else:
                out[f"layers/#{i}/mixer/{name}"] = v
    return out


@pytest.mark.parametrize("slab", [True, False], ids=["slab", "lockstep"])
@pytest.mark.parametrize("n_slots", [8, 3])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_cache_pspecs_match_jax(arch, mesh, n_slots, slab):
    jmesh, pmesh = _meshes(mesh)
    cfg = JC.get_smoke(arch)
    max_len = 24
    jcaches = jax.eval_shape(lambda: JT.make_caches(cfg, n_slots, max_len))
    jspecs = _flat(JSH.cache_pspecs(jcaches, jmesh, n_slots, slab=slab))
    pcaches = PT.make_caches(PC.get_smoke(arch), n_slots, max_len,
                             device="meta")
    pspecs = _cache_paths(SH.cache_pspecs(pcaches, pmesh, n_slots,
                                          slab=slab))
    _assert_same(jspecs, pspecs, cfg)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", PAGED)
def test_page_pspecs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    cfg = JC.get_smoke(arch)
    n_slots, max_len, page = 4, 24, 8
    jcaches = jax.eval_shape(lambda: JT.make_caches(cfg, n_slots, max_len))
    jlayout = JLayout(cfg, n_slots, max_len, page)
    for n_pages in (jlayout.pp * n_slots + 1, 16):
        keys = list(_flat(jax.tree_util.tree_map(lambda _: JP(),
                                                 jcaches)))
        jspecs = dict(zip(keys, JSH.page_pspecs(jcaches, jlayout, jmesh,
                                                n_pages)))
        pcfg = PC.get_smoke(arch)
        pcaches = PT.make_caches(pcfg, n_slots, max_len, device="meta")
        layout = PageLayout(pcfg, n_slots, max_len, page, device="meta")
        pspecs = _cache_paths(SH.page_pspecs(pcaches, layout, pmesh,
                                             n_pages))
        _assert_same(jspecs, pspecs, cfg)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_decode_state_pspecs_match_jax(mesh, n):
    jmesh, pmesh = _meshes(mesh)
    assert tuple(SH.batch_pspec(pmesh, n)) == \
        tuple(JSH.batch_pspec(jmesh, n))
    want = JST.decode_state_pspecs(jmesh, n)
    got = ST.decode_state_pspecs(pmesh, n)
    assert set(got) == set(want)
    assert all(tuple(got[k]) == tuple(want[k]) for k in want)


def test_activation_rules_match_jax():
    for name in MESHES:
        jmesh, pmesh = _meshes(name)
        assert SH.activation_rules(pmesh) == JSH.activation_rules(jmesh)
        over = {"seq": "model"}
        assert SH.activation_rules(pmesh, over) == \
            JSH.activation_rules(jmesh, over)


def test_local_slices_and_placements():
    """A tuple entry shards one dim over both axes, major first; the
    placements name the same layout per mesh dimension."""
    mesh = SH.AbstractMesh((2, 3), ("data", "model"))
    spec = SH.P(("data", "model"), None, "model")
    blocks = {(d, m): SH.local_slices(spec, (12, 5, 6), mesh,
                                      {"data": d, "model": m})
              for d in range(2) for m in range(3)}
    assert blocks[(1, 2)] == (slice(10, 12), slice(0, 5), slice(4, 6))
    assert blocks[(0, 1)] == (slice(2, 4), slice(0, 5), slice(2, 4))
    rows = sorted(b[0].start for b in blocks.values())
    assert rows == list(range(0, 12, 2))
    assert SH.shard_shape(spec, (12, 5, 6), mesh) == (2, 5, 2)
    with pytest.raises(ValueError, match="mesh order"):
        SH.placements(SH.P(("model", "data")), mesh)


@pytest.mark.parametrize("arg", ["2,4", "data=2,model=4", "model=4,data=2",
                                 " 1 , 8 "])
def test_parse_mesh_arg_matches_jax(arg):
    assert M.parse_mesh_arg(arg) == JMESH.parse_mesh_arg(arg)


@pytest.mark.parametrize("arg", ["2", "2,4,1", "0,2", "pod=2,model=2",
                                 "data=2,data=3"])
def test_parse_mesh_arg_errors_match_jax(arg):
    with pytest.raises(ValueError) as want:
        JMESH.parse_mesh_arg(arg)
    with pytest.raises(ValueError) as got:
        M.parse_mesh_arg(arg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args", [(1, 1, 1, 1, 1), (2, 4, 2, 2, 2),
                                  (3, 8, 4, 2, 4), (2, 6, 2, 3, 1)])
def test_plan_fleet_topology_matches_jax(args):
    assert M.plan_fleet_topology(*args) == JMESH.plan_fleet_topology(*args)


@pytest.mark.parametrize("args", [(0, 1, 1, 1, 1), (1, 1, 1, 1, 0),
                                  (2, 4, 3, 1, 2), (2, 3, 2, 2, 1)])
def test_plan_fleet_topology_errors_match_jax(args):
    with pytest.raises(ValueError) as want:
        JMESH.plan_fleet_topology(*args)
    with pytest.raises(ValueError) as got:
        M.plan_fleet_topology(*args)
    assert str(got.value) == str(want.value)

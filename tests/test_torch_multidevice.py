"""Port parity, multi-device: `ShardedBackend`, `DistributedBackend`, the
router over replica submeshes, `pipeline_apply`, `cross_pod_psum_int8`,
the re-mesh restore and the data-parallel train step, on one gloo process
group of four CPU ranks (a (data=2, model=2) mesh, a (4, 1) one for the
save, a 1-D 'pod' axis of four for the pipeline and the psum): the cases
of the forced-8-device JAX tests (`tests/test_multidevice.py`,
`tests/test_serve_sharded.py`, `tests/test_serve_paged.py`,
`tests/test_serve_speculative.py`), (2, 2) in place of their (4, 2).

A module-scoped fixture spawns the ranks once (`torch_multidevice_worker`)
and every scenario runs there; each test asserts on one scenario's
results. The JAX tokens come from this process, on one device, on the
same weights (the JAX smoke init, written with `save_pytree` and carried
into the port by `checkpoint.convert`). Speculation runs on nemotron: the
smoke h2o-danube's 8-token window refuses a speculating engine in the
port (a circular cache cannot roll back)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_multidevice_worker as W  # noqa: E402

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    if jax is None:
        pytest.skip("the ranks' weights are the JAX package's smoke init")
    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.models import transformer as JT
    workdir = str(tmp_path_factory.mktemp("multidevice"))
    for arch in W.WEIGHT_ARCHS:
        save_pytree(os.path.join(workdir, arch),
                    JT.init(jax.random.PRNGKey(0), JC.get_smoke(arch)))
    out, out["jax"] = W.spawn(workdir, lambda: {
        arch: _jax_tokens(workdir, arch) for arch in W.IDENTITY_ARCHS})
    out["workdir"] = workdir
    return out


def _ok(results, name):
    got = results[name]
    if isinstance(got, dict) and "error" in got:
        pytest.fail(f"scenario {name} raised on a rank:\n{got['error']}")
    return got


def _jax_tokens(workdir, arch):
    """The JAX package's greedy tokens on one device, the same weights."""
    from repro import serve as J
    from repro.checkpoint.manager import load_pytree
    from repro import configs as JC
    from repro.models import transformer as JT
    cfg = JC.get_smoke(arch)
    like = jax.eval_shape(lambda: JT.init(jax.random.PRNGKey(0), cfg))
    params = load_pytree(os.path.join(workdir, arch), like)
    m = J.ModelRegistry().load(arch, params=params)
    eng = J.InferenceEngine(m, J.EngineConfig(n_slots=4, max_len=32))
    rs = [eng.submit(p, g, arrival_step=i)
          for i, (p, g) in enumerate(W.jobs(m.cfg.vocab))]
    eng.run()
    return [list(map(int, r.generated)) for r in rs]


@pytest.mark.parametrize("arch", W.IDENTITY_ARCHS)
def test_sharded_greedy_identity(results, arch):
    """ShardedBackend on (2, 2), K = 1 and 3, decodes the local backend's
    greedy tokens, which are the JAX package's (JAX's own sharded engine
    fails this for falcon-mamba and minicpm3; the port is held to its
    local path and through it to JAX's single device)."""
    got = _ok(results, "identity")[arch]
    assert got["k1"] == got["local"] and got["k3"] == got["local"]
    assert got["local"] == results["jax"][arch]
    assert got["describe"] == {"backend": "sharded", "mesh_shape": [2, 2],
                               "mesh_axes": ["data", "model"],
                               "n_devices": 4}


def test_sharded_sampled_tokens_equal_local(results):
    got = _ok(results, "sampled")
    assert got["sharded"] == got["local"]


def test_slab_and_state_actually_shard(results):
    """Each rank holds its 2 of 4 slot rows and 1 of 2 kv heads of the slab
    and the state; 3 slots (not divisible) replicate the rows."""
    per_rank = _ok(results, "placement")
    assert [r[4]["rows"] for r in per_rank] == [(0, 2), (0, 2), (2, 2),
                                                (2, 2)]
    for r in per_rank:
        assert r[4]["k"] == (2, 1, 8, 8) and r[4]["tokens"] == (2,)
        assert r[3]["k"] == (3, 1, 8, 8) and r[3]["tokens"] == (3,)
        assert r[3]["rows"] == (0, 3)


@pytest.mark.parametrize("arch", W.PAGED_ARCHS)
def test_sharded_paged_identity_and_placement(results, arch):
    """Paged greedy decode on (2, 2) gives the local paged engine's tokens
    and pool metrics; the store keeps every page on every rank and half
    the kv heads (or the whole latent) on each."""
    per_rank = _ok(results, "paged")
    for r in per_rank:
        got = r[arch]
        assert got["sharded"] == got["local"]
        assert got["report"] == got["local_report"]
        full, leaf = got["full_leaf"], got["store_leaf"]
        assert leaf[0] == full[0]
        assert leaf[1] == (full[1] // 2 if full[1] % 2 == 0 and len(full) == 4
                           else full[1])


def test_sharded_paged_prefix_reuse(results):
    for r in _ok(results, "paged"):
        got = r["prefix"]
        assert got["sharded"] == got["local"]
        assert got["skipped"] == got["local_skipped"] > 0


def test_sharded_speculative_greedy_identity(results):
    for r in _ok(results, "speculative"):
        assert r[1] == r["plain"] and r[2] == r["plain"]
        assert r["draft_slab"][:2] == (2, 1)      # rows and heads split


def test_sharded_tier_swap_and_cancel_hygiene(results):
    got = _ok(results, "tiers")
    assert got["all_done"] and got["demotions"] >= 1
    assert got["tier"] == 0 and got["n_free"] == 2
    assert got["doomed"] == ("shed", "deadline")
    assert got["victim"] == ("shed", "cancel")
    assert got["keep"] == ("done", got["local_keep"])
    assert got["pool"] == (0, 2)


def test_sharded_decode_updates_in_place(results):
    """A dispatch writes the slab and the state where they lie (the port's
    counterpart of donation under pjit)."""
    got = _ok(results, "in_place")
    assert got["same_ptrs"] and got["written"]


def test_router_over_disjoint_replica_submeshes(results):
    got = _ok(results, "router")
    assert got["ranks"] == [[0, 1], [2, 3]]
    assert got["sharded"] == got["local"]
    assert all(len(t) == 5 for t in got["sharded"])
    assert got["completed"] == 6.0 and got["names"] == ["sharded"]
    assert [d["mesh_shape"] for d in got["describe"]] == [[1, 2], [1, 2]]


def test_distributed_backend_identity_and_describe(results):
    for rank, r in enumerate(_ok(results, "distributed")):
        assert r["dist"] == r["local"]
        assert r["describe"] == {
            "backend": "distributed", "mesh_shape": [2, 2],
            "mesh_axes": ["data", "model"], "n_devices": 4,
            "process_index": rank, "num_processes": 4, "replica": 0}


def test_pipeline_parallelism_matches_sequential(results):
    for r in _ok(results, "pipeline"):
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-4)


def test_pipeline_gradients_flow(results):
    for r in _ok(results, "pipeline"):
        np.testing.assert_allclose(r["grad"], r["grad_ref"], rtol=1e-4,
                                   atol=1e-5)


def test_cross_pod_int8_psum(results):
    """Near the f32 sum, and equal to numpy's recomputation: codes at the
    largest scale over the axis (max|x| / 127 + 1e-12, one rounding),
    summed in int32, times that scale."""
    per_rank = _ok(results, "psum_int8")
    xs = [W.psum_input(r) for r in range(W.WORLD)]
    want = np.sum(xs, axis=0)
    scale = max(np.float32(np.float64(np.abs(x).max())
                           * np.float64(np.float32(1 / 127)) + 1e-12)
                for x in xs)
    codes = sum(np.clip(np.rint(x / scale), -127, 127).astype(np.int32)
                for x in xs)
    recomputed = codes.astype(np.float32) * scale
    for got in per_rank:
        err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert err < 0.05, err
        np.testing.assert_array_equal(got, recomputed)


def test_elastic_remesh_restore(results):
    """Saved sharded on (4, 1), restored onto (2, 2): every rank's block
    and every whole leaf bitwise; the file is the JAX package's
    save_pytree of the same tree."""
    from repro.checkpoint.manager import save_pytree
    from repro_torch import configs as PC
    from repro_torch import tree as tu
    from repro_torch.checkpoint import convert as CV
    per_rank = _ok(results, "remesh")
    for r in per_rank:
        assert r["step"] == 1 and r["local_ok"] and r["whole_ok"]
        assert r["n_sharded"] > 0
    workdir = results["workdir"]
    params = CV.convert(os.path.join(workdir, W.DANUBE),
                        PC.get_smoke(W.DANUBE).n_layers)
    tree = tu.tree_map(lambda t: t.numpy(), W.remesh_tree(params))
    ref = os.path.join(workdir, "remesh_jax")
    save_pytree(ref, tree)
    with np.load(os.path.join(per_rank[0]["dir"], "step-1",
                              "arrays.npz")) as got, \
            np.load(os.path.join(ref, "arrays.npz")) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


def test_sharded_train_step_matches_single_process(results):
    """Data-parallel over 'data' = 2: the loss of every step within 1e-3 of
    the single-process run's; a run that fails at step 3 resumes from the
    step-2 checkpoint with state_shardings and ends on the uninterrupted
    sharded run's loss."""
    for r in _ok(results, "training"):
        np.testing.assert_allclose(r["sharded"], r["single"], atol=1e-3)
        assert r["failed"] and r["resumed_from"] == 2
        assert r["resumed"] == r["sharded"][2:]


# ------------------------------------------------------------------ the card
# one rank on NCCL, the checks of chip_smoke.py's phase 24 at smoke size


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, 8])
def test_cuda_sharded_one_rank_matches_local(cuda_device, page_size):
    """ShardedBackend on a (1, 1) NCCL mesh and DistributedBackend decode
    the local backend's greedy tokens, slab and pages, through the same
    captured dispatch."""
    from repro_torch.serve import (DistributedBackend, EngineConfig,
                                   InferenceEngine, ModelRegistry,
                                   ShardedBackend)
    m = ModelRegistry().load(W.NEMOTRON)
    toks = []
    for backend in (None, ShardedBackend(mesh_shape=(1, 1)),
                    DistributedBackend(mesh_shape=(1, 1))):
        eng = InferenceEngine(m, EngineConfig(n_slots=4, max_len=32,
                                              decode_chunk=2,
                                              page_size=page_size),
                              backend=backend)
        rs = [eng.submit(p, g) for p, g in W.jobs(m.cfg.vocab)]
        eng.run()
        toks.append([list(map(int, r.generated)) for r in rs])
        if backend is not None:
            assert eng.backend.describe()["mesh_shape"] == [1, 1]
    assert toks[1] == toks[0] and toks[2] == toks[0]


@pytest.mark.cuda
def test_cuda_pipeline_and_int8_psum_one_rank(cuda_device):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.compression import (_quant_int8,
                                                     cross_pod_psum_int8)
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_reference)
    from repro_torch.launch import mesh as M
    M.ensure_world("cuda")
    mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pod",),
                      _init_backend=False)
    ws = torch.from_numpy(W.pipeline_inputs()[0][:1]).to(cuda_device)
    x = torch.from_numpy(W.pipeline_inputs()[1]).to(cuda_device)

    def fn(w, h):
        return torch.tanh(h @ w)
    torch.testing.assert_close(pipeline_apply(ws, x, fn, mesh),
                               pipeline_reference(ws, x, fn), rtol=1e-4,
                               atol=1e-5)
    v = torch.from_numpy(W.psum_input(0)).to(cuda_device)
    q, scale = _quant_int8(v)
    assert torch.equal(cross_pod_psum_int8(v, mesh), q.float() * scale)

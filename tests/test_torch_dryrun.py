"""Port parity, the dry-run: `launch/shapes.py`, `launch/dryrun.py`,
`launch/dryrun_all.py` and `analysis/dispatch_cost.py` (the counterpart
of `repro.analysis.hlo`) against the JAX package.

The grid, its skips and policies equal JAX's; `cell_inputs` gives JAX's
shapes and dtypes leaf for leaf (a JAX leaf stacked over a scan slot's
layers stands for each of those layers) on the meta device, so the
nemotron-4-340b train state (> 300e9 parameters) allocates nothing; the
analyzer's FLOPs equal `hlo.analyze`'s on hlo's own oracles (a matmul, a
loop of matmuls, nested loops) and, within FLOP_RTOL, on the smoke train,
prefill and legacy decode steps of h2o-danube and deepseek-moe (bytes are
not compared: XLA fuses, eager PyTorch does not); collectives on the
dry-run's fake group count their result bytes and wire bytes (1x, 2x for
an all-reduce); `roofline_terms` is JAX's formula at the card's peaks;
`done_keys` reads a ledger as JAX's does; a full cell runs as a user
runs it; the legacy one-token decode gives JAX's logits."""

import dataclasses
import importlib
import json
import os
import resource
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.analysis import hlo as HA  # noqa: E402
from repro.checkpoint import manager as JM  # noqa: E402
from repro.distributed import steps as JST  # noqa: E402
from repro.launch import dryrun_all as JDA  # noqa: E402
from repro.launch import shapes as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import configs as PC  # noqa: E402
from repro_torch.analysis import dispatch_cost as DC  # noqa: E402
from repro_torch.checkpoint import convert as CV  # noqa: E402
from repro_torch.distributed import steps as ST  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import dryrun_all as DA  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import shapes as PS  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402

from torch_serve_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
# the port's counted FLOPs against XLA's on the same smoke step (measured
# 0.99-1.06: the MoE train step's dispatch and combine differ most)
FLOP_RTOL = 0.10
PARITY_ARCHS = ("h2o_danube_1_8b", "deepseek_moe_16b")
SHAPE_ARCHS = ("h2o_danube_1_8b", "deepseek_moe_16b", "whisper_large_v3")
KINDS = ("train", "prefill", "decode")


def _jax_dryrun():
    """`repro.launch.dryrun`, imported without the 512-device XLA flag its
    import sets for later processes of this one."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


# ------------------------------------------------------------------ grid

def test_grid_policies_and_skips_equal_jax():
    """40 cells, 35 runnable and 5 long_500k skips of the full-attention
    archs; the shapes, LONG_OK, the skip reason, the policies, the arch
    order and the dry-run config equal the JAX package's."""
    assert [dataclasses.astuple(s) for s in PS.SHAPES] == \
        [dataclasses.astuple(s) for s in JS.SHAPES]
    assert PS.LONG_OK == JS.LONG_OK
    assert PS.LONG_SKIP_REASON == JS.LONG_SKIP_REASON
    assert {k: dataclasses.asdict(v) for k, v in PS.POLICIES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.POLICIES.items()}
    assert DA.ARCH_ORDER == JDA.ARCH_ORDER
    cells = [(a, s.name) for a in DA.ARCH_ORDER for s in PS.SHAPES]
    got = [PS.cell_applicable(a, s) for a, s in cells]
    assert got == [JS.cell_applicable(a, s) for a, s in cells]
    skips = [r for ok, r in got if not ok]
    assert len(cells) == 40 and len(skips) == 5
    assert all("full-attention" in r for r in skips)
    for arch in DA.ARCH_ORDER:
        p, j = PS.config_for_dryrun(arch), JS.config_for_dryrun(arch)
        for f in ("param_dtype", "dtype", "remat", "remat_policy",
                  "n_layers", "d_model", "vocab"):
            assert getattr(p, f) == getattr(j, f), (arch, f)


def _jax_leaves(tree):
    """(shape, dtype) of every JAX leaf, a leaf stacked over layers
    ('blocks' / 'enc_blocks') once per layer."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = jax.tree_util.keystr(path)
        stacked = "['blocks']" in key or "['enc_blocks']" in key
        shape = tuple(leaf.shape)
        dt = str(jnp.dtype(leaf.dtype))
        if stacked:
            out += [(shape[1:], dt)] * shape[0]
        else:
            out.append((shape, dt))
    return Counter(out)


def _port_leaves(tree):
    out = []

    def walk(x, name=""):
        if isinstance(x, dict):
            for k, v in x.items():
                if k != "pos_table":        # a buffer, no JAX leaf
                    walk(v, k)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            assert x.device.type == "meta", name
            out.append((tuple(x.shape), str(x.dtype).replace("torch.", "")))
    walk(tree)
    return Counter(out)


def _smoke(pkg_c, pkg_s, arch):
    pol = pkg_s.policy_for(arch)
    return dataclasses.replace(
        pkg_c.get_smoke(arch), param_dtype=pol.param_dtype,
        dtype=pol.act_dtype, remat=True, remat_policy=pol.remat_policy)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", SHAPE_ARCHS)
def test_cell_inputs_match_jax(arch, size, kind):
    """The port's step inputs on the meta device have JAX's shapes and
    dtypes, leaf for leaf: params, AdamW state and step, batch, caches,
    token and index."""
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    if size == "smoke":
        jcfg, pcfg = _smoke(JC, JS, arch), _smoke(PC, PS, arch)
        jcell = JS.ShapeCell("s", kind, 32, 4)
        pcell = PS.ShapeCell("s", kind, 32, 4)
    else:
        jcfg, pcfg = JS.config_for_dryrun(arch), PS.config_for_dryrun(arch)
        jcell, pcell = JS.SHAPES_BY_NAME[name], PS.SHAPES_BY_NAME[name]
    jkind, jargs = JS.cell_inputs(arch, jcell, cfg=jcfg)
    pkind, pargs = PS.cell_inputs(arch, pcell, cfg=pcfg)
    assert pkind == jkind == kind
    assert len(pargs) == len(jargs)
    for p, j in zip(pargs, jargs):
        assert _port_leaves(p) == _jax_leaves(j)


def test_nemotron_train_state_allocates_nothing():
    """The nemotron-4-340b train_4k state on the meta device: more than
    300e9 parameters, and the process's resident memory grows by less
    than 1 GB."""
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * resource.getpagesize()

    before = rss()
    kind, (state, batch) = PS.cell_inputs("nemotron_4_340b",
                                          PS.SHAPES_BY_NAME["train_4k"])
    grown = rss() - before
    n = sum(t.numel() for t in _tensors(state["params"]))
    assert kind == "train" and n > 300e9
    assert n == PS.config_for_dryrun("nemotron_4_340b").param_count() + \
        _norm_count(state["params"])
    assert grown < 1e9, grown


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _norm_count(params):
    """Norm scales and biases, which `param_count` leaves out."""
    def walk(x, name=""):
        if isinstance(x, dict):
            return sum(walk(v, k) for k, v in x.items())
        if isinstance(x, list):
            return sum(walk(v) for v in x)
        return x.numel() if name in ("scale", "bias") else 0
    return walk(params)


# -------------------------------------------------------------- analyzer

def _hlo(fn, *args):
    return HA.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_analyzer_matmul_equals_hlo():
    a, b = np.zeros((256, 512), np.float32), np.zeros((512, 128), np.float32)
    got = DC.analyze(lambda x, y: x @ y, torch.from_numpy(a),
                     torch.from_numpy(b))
    want = _hlo(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert got["flops"] == want["flops"] == 2 * 256 * 512 * 128


def test_analyzer_loop_of_matmuls_equals_hlo():
    """A K-step loop: hlo multiplies the while body by its trip count; the
    eager loop runs its body K times."""
    def jg(x, ws):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]

    def tg(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    x, ws = np.zeros((64, 128), np.float32), np.zeros((10, 128, 128),
                                                      np.float32)
    got = DC.analyze(tg, torch.from_numpy(x), torch.from_numpy(ws))
    want = _hlo(jg, jnp.asarray(x), jnp.asarray(ws))
    expect = 10 * (2 * 64 * 128 * 128 + 64 * 128)
    assert got["flops"] == expect
    assert abs(want["flops"] - expect) / expect < 0.02
    assert got["transcendentals"] == 10 * 64 * 128


def test_analyzer_nested_loops_multiply_as_hlo():
    def jg(x, ws):
        def outer(x, _):
            return jax.lax.scan(lambda x, w: (x @ w, None), x, ws)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def tg(x, ws):
        for _ in range(3):
            for w in ws:
                x = x @ w
        return x

    x, ws = np.zeros((32, 64), np.float32), np.zeros((5, 64, 64), np.float32)
    got = DC.analyze(tg, torch.from_numpy(x), torch.from_numpy(ws))
    want = _hlo(jg, jnp.asarray(x), jnp.asarray(ws))
    assert got["flops"] == 3 * 5 * 2 * 32 * 64 * 64
    assert abs(want["flops"] - got["flops"]) / got["flops"] < 0.05


def test_analyzer_bytes_peak_and_breakdown():
    """An elementwise op reads and writes its bytes once each (hlo's
    bounds on the same program); the peak counts only what the call made
    and held at once; breakdown ranks by bytes as hlo's does."""
    a = torch.empty((1024, 1024), device="meta")

    def f(x):
        ys = [x + 1.0 for _ in range(3)]
        return ys[0] * 2.0

    r = DC.analyze(f, a)
    one = 1024 * 1024 * 4
    assert r["bytes"] == 4 * 2 * one and r["flops"] == 4 * 1024 * 1024
    assert r["peak_bytes"] == 4 * one
    rows = DC.breakdown(f, a, top=2)
    assert rows[0] == ("add 4MiB", 3 * 2.0 * one, 3.0 * 1024 * 1024)
    hlo = _hlo(lambda x: x + 1.0, jnp.zeros((1024, 1024), jnp.float32))
    assert 0.5 * hlo["bytes"] <= 2 * one <= 3 * hlo["bytes"]


def test_analyzer_keys_are_hlos_less_the_tpu_ones():
    want = _hlo(lambda x: x + 1.0, jnp.zeros((8,), jnp.float32))
    got = DC.analyze(lambda x: x + 1.0, torch.zeros(8))
    assert set(want) - set(got) == {"bytes_tpu_adjusted", "convert_bytes"}
    assert set(got["collectives"]) == set(want["collectives"])


def _run_script(code, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


FAKE_GROUP_SCRIPT = r"""
import json, torch
from repro_torch.analysis import dispatch_cost as DC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D, mesh as M
out = {}
with M.fake_world(8):
    mesh = M.make_local_mesh(2, 4, device="meta")
    def f(x):
        g = SH.all_gather_axis(x, 1, SH.axis_group(mesh, "model"))
        torch.distributed.all_reduce(x, group=SH.axis_group(mesh, "data"))
        return g
    x = torch.empty((3, 5), device="meta")
    r = DC.analyze(f, x)
    out["coll"] = r["collectives"]
    out["wire"] = r["wire_bytes"]
    try:
        M.ensure_world("cpu")
    except ValueError as e:
        out["refused"] = str(e)
out["after"] = torch.distributed.is_initialized()
rec = D.run_cell("gemma2_27b", "decode_32k")
out["gemma2"] = {k: rec[k] for k in ("status", "n_chips", "collectives")}
print(json.dumps(out))
"""


def test_collectives_on_the_fake_group():
    """On an 8-rank fake group, an all-gather over 'model' (4 ranks)
    counts its (3, 20) f32 result, an all-reduce over 'data' its (3, 5):
    wire 1x and 2x; a serving mesh refuses the fake group; the group goes
    with its block. A cell whose kv heads split over 'model' (gemma2's 16
    over 16) all-gathers every attention layer's heads."""
    got = _run_script(FAKE_GROUP_SCRIPT)
    coll = got["coll"]
    assert coll["all-gather"] == {"count": 1.0, "bytes": 3 * 20 * 4.0}
    assert coll["all-reduce"] == {"count": 1.0, "bytes": 3 * 5 * 4.0}
    assert got["wire"] == 3 * 20 * 4 + 2 * 3 * 5 * 4
    assert "fake" in got["refused"] and not got["after"]
    g = got["gemma2"]
    assert g["status"] == "ok" and g["n_chips"] == 256
    assert g["collectives"]["counts"]["all-gather"] == \
        PC.get_config("gemma2_27b").n_layers
    assert g["collectives"]["wire_bytes_per_device"] > 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_smoke_step_flops_match_hlo(arch, kind):
    """The smoke step (train with grad_accum, prefill into caches, the
    legacy one-token decode) counted on one device, against `hlo.analyze`
    of JAX's jitted step on the same shapes: FLOPs within FLOP_RTOL."""
    jcell, pcell = JS.ShapeCell("s", kind, 32, 4), PS.ShapeCell("s", kind,
                                                                32, 4)
    jcfg, pcfg = _smoke(JC, JS, arch), _smoke(PC, PS, arch)
    _, jargs = JS.cell_inputs(arch, jcell, cfg=jcfg)
    want = _hlo(JS.make_step_fn(arch, jcell, cfg=jcfg, mesh_dp=1), *jargs)
    _, pargs = PS.cell_inputs(arch, pcell, cfg=pcfg)
    got = DC.analyze(PS.make_step_fn(arch, pcell, cfg=pcfg, mesh_dp=1),
                     *pargs)
    ratio = got["flops"] / want["flops"]
    print(f"{arch} {kind}: port {got['flops']:.6g} / XLA {want['flops']:.6g}"
          f" FLOPs = {ratio:.4f}, bytes {got['bytes'] / want['bytes']:.3f}")
    # (PERF.md's ratios: pytest -s; bytes only reported, XLA fuses)
    assert abs(ratio - 1) < FLOP_RTOL, (got["flops"], want["flops"])
    assert got["wire_bytes"] == 0 and got["peak_bytes"] > 0


# ---------------------------------------------------------------- dry-run

def test_roofline_terms_follow_jax(monkeypatch):
    """JAX's formula on the card's constants: bf16 tensor-core peak, HBM
    and NVLink one way in place of the TPU's ICI link."""
    jd = _jax_dryrun()
    monkeypatch.setattr(jd.M, "PEAK_BF16_FLOPS", M.PEAK_BF16_FLOPS)
    monkeypatch.setattr(jd.M, "HBM_BW", M.HBM_BW)
    monkeypatch.setattr(jd.M, "ICI_BW_PER_LINK", M.NVLINK_BW)
    for kind, flops, bytes_, wire in (("train", 3e15, 2e12, 5e11),
                                      ("decode", 4e10, 6e10, 0.0),
                                      ("prefill", 1e14, 1e11, 9e12)):
        rec = {"status": "ok", "kind": kind, "batch": 128, "seq": 4096,
               "n_chips": 256, "active_params": 1_800_000_000,
               "hlo_flops_per_device": flops, "hlo_bytes_per_device": bytes_,
               "collectives": {"wire_bytes_per_device": wire}}
        assert D.roofline_terms(rec) == jd.roofline_terms(rec)
    assert D.roofline_terms({"status": "error"}) == {}
    assert M.NVLINK_BW * 2 == M.NVLINK_BW_TOTAL == 900e9


def test_done_keys_reads_a_ledger_as_jax():
    lines = [{"arch": "a", "shape": "train_4k", "multi_pod": False,
              "status": "ok"},
             {"arch": "a", "shape": "long_500k", "multi_pod": True,
              "status": "skipped"},
             {"arch": "b", "shape": "decode_32k", "multi_pod": False,
              "status": "error", "error": "x"},
             {"arch": "c", "shape": "decode_32k", "multi_pod": False,
              "status": "timeout"}]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ledger.jsonl")
        with open(path, "w") as f:
            for r in lines:
                f.write(json.dumps(r) + "\n")
            f.write("{truncated\n")
        assert DA.done_keys(path) == JDA.done_keys(path) == {
            ("a", "train_4k", False), ("a", "long_500k", True)}
        assert DA.done_keys(os.path.join(d, "none")) == set()


def test_full_cell_as_a_user_runs_it(tmp_path):
    """`python -m repro_torch.launch.dryrun --arch h2o_danube_1_8b --shape
    decode_32k --out L`: one ledger line with the JAX package's record
    keys less its two TPU-only ones (and its XLA code size), status ok on
    256 ranks. h2o-danube's 8 kv heads do not split over 'model' (16), so
    under the port's placement the cell issues no collective: wire 0."""
    jd = _jax_dryrun()
    out = tmp_path / "ledger.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "h2o_danube_1_8b", "--shape", "decode_32k",
                        "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr
    rec = json.loads(out.read_text().splitlines()[0])
    src = Path(jd.__file__).read_text()
    jax_keys = {k for k in ("arch", "shape", "multi_pod", "status", "kind",
                            "n_chips", "seq", "batch", "lower_s",
                            "compile_s", "hlo_flops_per_device",
                            "hlo_bytes_per_device", "collectives",
                            "analysis_warnings", "params", "active_params",
                            "variant", "roofline")
                if f'"{k}"' in src}
    assert len(jax_keys) == 18
    mem = {f"mem_{a}" for a in ("argument_size_in_bytes",
                                "output_size_in_bytes",
                                "temp_size_in_bytes")}
    assert jax_keys | mem <= set(rec)
    assert not {"hlo_bytes_tpu_adjusted",
                "xla_cost_analysis_flops_unscaled"} & set(rec)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert set(rec["collectives"]) == {"counts", "result_bytes",
                                       "wire_bytes_per_device"}
    assert rec["collectives"]["wire_bytes_per_device"] == 0
    assert rec["hlo_flops_per_device"] > 0 and rec["fits_hbm"] is True
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["params"] == JS.config_for_dryrun(
        "h2o_danube_1_8b").param_count()


def test_legacy_decode_gives_jax_logits():
    """Prefill into caches, then JAX's legacy one-token decode (n_steps
    None) on the smoke h2o-danube, f32, weights carried: the port's
    logits equal JAX's within 1e-4."""
    cfg = JC.get_smoke("h2o_danube_1_8b")
    pcfg = PC.get_smoke("h2o_danube_1_8b")
    jparams = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        JM.save_pytree(d, jparams)
        pparams = CV.convert(d, cfg.n_layers, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    jc = JT.make_caches(cfg, 2, 16)
    jl, jc = jax.jit(JST.make_prefill_step(cfg))(
        jparams, {"tokens": jnp.asarray(toks)}, jc)
    jd, _ = jax.jit(JST.make_decode_step(cfg))(
        jparams, jc, jnp.asarray(nxt), jnp.int32(6))
    pc = PT.make_caches(pcfg, 2, 16, device="cpu")
    with ops.reference_path(), torch.no_grad():
        pl, pc = ST.make_prefill_step(pcfg)(
            pparams, {"tokens": torch.from_numpy(toks)}, pc)
        pd, _ = ST.make_decode_step(pcfg)(
            pparams, pc, torch.from_numpy(nxt),
            torch.tensor(6, dtype=torch.int32))
    assert tuple(pd.shape) == (2, 1, cfg.vocab)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-4)


def test_dryrun_modules_import_no_jax():
    """The dry-run's modules (and the analyzer) import neither JAX nor the
    JAX package: the card's host runs them without JAX."""
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.dryrun_all, repro_torch.launch.shapes, "
            "repro_torch.analysis.dispatch_cost; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)

"""Port parity, the paper's grid and figures: `repro_torch.core.bench_specs`,
`analysis.roofline`, `analysis.cost`, `launch.mesh` and `figures/` against
the JAX package (`repro.core.bench_specs`, `repro.analysis.roofline`,
`benchmarks/`) on the CPU.

Tolerances: the grid, the analytic model, the batch sweep's 800 rows and
fig6's byte columns exactly (the batch sweep byte for byte); the
instantiated points' outputs 1e-5 against JAX's `fn` on the same weights;
counted MACs exactly `resource_report`'s effective MACs; against JAX's
HLO MACs (float points) within HLO_MAC_TOL, measured: equal for dense and
tree points, and 1 + 1/(2m) for a systolic point, whose mask multiply
(n x p elementwise FLOPs) XLA counts and FlopCounterMode does not; the
roofline dicts exactly."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_serve_parity import NEMOTRON, engines, jax, jobs, needs_jax, serve
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_serve_parity import torch

if jax is not None:
    from repro.analysis import roofline as JR
    from repro.core import bench_specs as JBS

from repro_torch.analysis import cost
from repro_torch.analysis import roofline as PR
from repro_torch.core import bench_specs as BS
from repro_torch.core.conv import conv_params
from repro_torch.figures import batch_sweep, common, fig6_precision
from repro_torch.figures import table3_tilesweep
from repro_torch.launch import mesh as M

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
HLO_MAC_TOL = 0.032          # 1/(2m) at the smallest systolic m (16)
FOUR = ("gemmt-RP-S", "gemms-RP-S", "conv1d-FU-S", "conv2d-RP-S")


def _gen():
    return torch.Generator().manual_seed(0)


@needs_jax
def test_table_ii_and_grid_equal_jax():
    assert list(BS.BY_NAME) == list(JBS.BY_NAME)
    assert BS.SPARSITIES == JBS.SPARSITIES
    assert BS.PRECISIONS == JBS.PRECISIONS
    n = 0
    for p, j in zip(BS.TABLE_II, JBS.TABLE_II, strict=True):
        assert (p.name, p.kernel, p.unroll, p.size, p.dims, p.bk, p.bn) \
            == (j.name, j.kernel, j.unroll, j.size, j.dims, j.bk, j.bn)
        for ps, js in zip(BS.sweep(p), JBS.sweep(j), strict=True):
            assert (ps.sparsity, ps.bits) == (js.sparsity, js.bits)
            assert ps.gemm_dims() == js.gemm_dims()
            assert ps.ops_per_invocation() == js.ops_per_invocation()
            assert ps.resource_report() == js.resource_report()
            ks, kj = ps.kratos_spec(), js.kratos_spec()
            assert (ks.impl, ks.unroll, ks.seed) == (kj.impl, kj.unroll,
                                                     kj.seed)
            n += 1
    assert n == 800


@needs_jax
def test_batch_sweep_csv_byte_identical(tmp_path, monkeypatch):
    from benchmarks import batch_sweep as JB
    out = tmp_path / "jax.csv"
    monkeypatch.setattr(sys, "argv", ["batch_sweep", "--out", str(out)])
    JB.main()
    assert batch_sweep.design_space() == out.read_text()
    ours = tmp_path / "sub" / "port.csv"
    batch_sweep.main(["--out", str(ours)])
    assert ours.read_bytes() == out.read_bytes()
    assert len(out.read_text().splitlines()) == 801


@needs_jax
@pytest.mark.parametrize("name", FOUR)
def test_instantiate_fn_matches_jax_fn(name):
    """The training-time apply on the reference path against JAX's
    `backend="ref"` fn, JAX's weights and input carried as numpy."""
    js = dataclasses.replace(JBS.BY_NAME[name], sparsity=0.5)
    jp, jx, jfn = JBS.instantiate(js)
    want = np.asarray(jax.jit(jfn)(jp, jx))
    ps = dataclasses.replace(BS.BY_NAME[name], sparsity=0.5)
    params, x, fn = BS.instantiate(ps, generator=_gen(), device="cpu")
    assert params["w"].shape == jp["w"].shape and x.shape == jx.shape
    got = fn(conv_params(jp), torch.from_numpy(np.array(jx)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(BS.BY_NAME))
def test_counted_macs_equal_effective_macs(name):
    """FlopCounterMode over the plain path counts exactly the analytic
    effective MACs (tree: the kept elements; systolic: dense), and the
    figures' point reads the same count."""
    for s, b in ((0.0, None), (0.5, 8), (0.9, 4), (0.3, 1)):
        spec = dataclasses.replace(BS.BY_NAME[name], sparsity=s, bits=b)
        params, x, fn = BS.instantiate(spec, generator=_gen(), device="cpu")
        c = cost.count(fn, params, x)
        rep = spec.resource_report()
        # the count is an integer; the analytic value a float product of
        # the dense MACs and the kept fraction, within an ulp of it
        assert c["macs"] == round(rep["effective_macs"]), (name, s, b)
        assert c["macs"] == pytest.approx(rep["effective_macs"], rel=1e-15)
        y = fn(params, x)
        assert c["bytes"] == cost.nbytes(params, x, y)
        pt = common.point(spec, "cpu")
        assert pt["macs"] == c["macs"] and pt["device_ms"] == common.DASH
        assert pt["params"]["w"].shape == params["w"].shape
        assert pt["bound_ms"] > 0 and "/" in pt["kernel"]


@needs_jax
@pytest.mark.parametrize("name,s", [
    ("gemmt-RP-S", 0.5), ("gemms-RP-S", 0.5), ("conv1d-FU-S", 0.5),
    ("conv2d-RP-S", 0.5), ("conv2d-FU-S", 0.0), ("gemmt-FU-S", 0.9)])
def test_counted_macs_against_jax_hlo(name, s):
    from benchmarks.common import hlo_cost
    js = dataclasses.replace(JBS.BY_NAME[name], sparsity=s)
    jp, jx, jfn = JBS.instantiate(js)
    hlo = hlo_cost(jfn, jp, jx)["macs"]
    ps = dataclasses.replace(BS.BY_NAME[name], sparsity=s)
    _, _, fn = BS.instantiate(ps, generator=_gen(), device="cpu")
    got = cost.count(fn, conv_params(jp),
                     torch.from_numpy(np.array(jx)))["macs"]
    assert abs(hlo / got - 1.0) <= HLO_MAC_TOL, (hlo, got)
    if ps.kernel != "gemms" or s == 0.0:
        assert hlo == got


def test_count_on_plain_versions_and_time_ms_refuses_cpu():
    """Counts come from a plain path: the wrapper's CPU plain version is
    ATen code FlopCounterMode counts; time_ms refuses CPU tensors."""
    spec = dataclasses.replace(BS.BY_NAME["gemmt-FU-S"], sparsity=0.5)
    params, x, _ = BS.instantiate(spec, generator=_gen(), device="cpu")
    packed, pfn = BS.pack_point(spec, params)
    assert cost.count(pfn, packed, x)["macs"] == \
        spec.resource_report()["effective_macs"]
    with pytest.raises(ValueError, match="card"):
        cost.time_ms(pfn, packed, x)
    with pytest.raises(ValueError, match="card"):
        cost.time_ms(lambda: None)


@needs_jax
def test_roofline_point_equal():
    for flops, b, wall in ((1e9, 1e6, 1e-3), (0.0, 0.0, 0.0), (5e12, 1e12,
                                                               2.0)):
        for pk in ((), (M.PEAK_F32_FLOPS, M.HBM_BW)):
            assert PR.roofline_point(flops, b, wall, PR.Peaks(*pk)) == \
                JR.roofline_point(flops, b, wall, JR.Peaks(*pk))
    assert PR.Peaks() == PR.Peaks(2.0e11, 5.0e10)
    assert PR.Peaks().ridge == JR.Peaks().ridge


@needs_jax
def test_dispatch_and_replica_rooflines_read_the_ports_trace():
    """The port's own tracer events with the ledger on: both packages'
    functions give equal rows on the same event list (with and without a
    static cost), and equal replica rooflines on the port's summary."""
    _, eng = engines(NEMOTRON, n_slots=2, max_len=48, decode_chunk=2,
                     trace={}, ledger={})
    serve(eng, jobs(eng.model.cfg.vocab, n=3, gen=5))
    evs = list(eng.trace.events)
    peaks = (M.PEAK_F32_FLOPS, M.HBM_BW)
    static = {"flops": 1.5e6, "bytes": 3.0e6}
    for hc in (None, static):
        got = PR.dispatch_rooflines(evs, hc, PR.Peaks(*peaks))
        assert got == JR.dispatch_rooflines(evs, hc, JR.Peaks(*peaks))
        assert len(got) > 0
    summary = eng.ledger.summary()
    for hc in (None, static):
        assert PR.replica_roofline(summary, 0.25, hc, 3, PR.Peaks()) == \
            JR.replica_roofline(summary, 0.25, hc, 3, JR.Peaks())


@needs_jax
@pytest.mark.parametrize("g", table3_tilesweep.GRAIN)
def test_kept_fraction_equal(g):
    from benchmarks import table3_tilesweep as JT
    w = np.random.default_rng(0).standard_normal((512, 512))
    mask = np.abs(w) > np.quantile(np.abs(w), 0.95)
    assert table3_tilesweep.kept_fraction(mask, g) == JT.kept_fraction(mask,
                                                                       g)


@needs_jax
def test_fig6_byte_columns_equal(capsys):
    from benchmarks import fig6_precision as JF6
    JF6.verify_packed_sizes()
    JF6.run()
    lines = capsys.readouterr().out.splitlines()
    head = lines.index(",".join(["kernel", "sparsity", "bits",
                                 "weight_bytes", "bytes_fraction",
                                 "time_fraction", "equiv_sparsity"]))
    want = [r.split(",") for r in lines[head + 1:head + 46]]
    fig6_precision.verify_packed_sizes()
    got = fig6_precision.run(device="cpu")["csv"]
    assert len(got) == len(want) == 45
    keep = ("kernel", "sparsity", "bits", "weight_bytes", "bytes_fraction",
            "equiv_sparsity")
    for g, w in zip(got, want):
        assert [g[k] for k in keep] == [w[i] for i in (0, 1, 2, 3, 4, 6)]
        assert g["device_ms"] == common.DASH


def test_mesh_peaks_and_refusals():
    assert (M.PEAK_BF16_FLOPS, M.PEAK_INT8_OPS, M.PEAK_F32_FLOPS,
            M.HBM_BW) == (989e12, 1979e12, 67e12, 3.35e12)
    assert M.PEAK_FLOPS == {"float32": 67e12, "bfloat16": 989e12,
                            "int8": 1979e12}
    # the mesh builders run on the card unless the caller asks for the CPU
    # (a gloo mesh): without a card the default refuses; the arithmetic
    # needs no process group
    if not torch.cuda.is_available():
        for fn, args in ((M.make_production_mesh, ()),
                         (M.make_local_mesh, ()),
                         (M.replica_meshes, (2, 1, 2)),
                         (M.process_meshes, (2, 1, 2)),
                         (M.fleet_topology, (2, 1, 2))):
            with pytest.raises((RuntimeError, ValueError)):
                fn(*args)
    assert M.parse_mesh_arg("2,4") == (2, 4)
    assert M.plan_fleet_topology(2, 1, 1, 1, 1)["global_device_count"] == 2
    r = cost.roofline_seconds(2 * 67e12, 3.35e12, "float32")
    assert r["t"] == 2.0 and r["bound"] == "compute"
    assert cost.bound_ms(67e9, 3.35e12, "float32") == (1000.0, "bytes")


def test_card_roof_is_one_peaks_table():
    """The card's roof is a `roofline.Peaks` at the mesh peaks: the least
    time `cost.roofline_seconds` computes is where `roofline_point` puts
    the point on that roof, in the same bounding resource."""
    for dtype, peak in M.PEAK_FLOPS.items():
        peaks = cost.PEAKS[dtype]
        assert peaks == PR.Peaks(peak_flops=peak, peak_bw=M.HBM_BW)
        for flops, bytes_ in ((1e9, 1e6), (1e6, 1e9), (3e12, 7e9)):
            r = cost.roofline_seconds(flops, bytes_, dtype)
            pt = PR.roofline_point(flops, bytes_, r["t"], peaks)
            assert pt["bound"] == r["bound"], (dtype, flops, bytes_)
            assert pt["utilization"] == pytest.approx(1.0, rel=1e-12)


# one case of each buffer format `pack` produces: the spec, the kernel
# `apply_packed` launches for it, the figures' format name
PACKED_CASES = {
    "w": (dict(), "dense_matmul", "w"),
    "qt-w8": (dict(bits=8), "quant_matmul", "qt-w8"),
    "qt-w4": (dict(bits=4), "quant_matmul", "qt-w4"),
    "qt-w8a8": (dict(bits=8, act_bits=8), "quant_matmul_w8a8", "qt-w8a8"),
    "blocks": (dict(sparsity=0.5, bk=4, bn=4), "bsr_matmul", "blocks"),
    "qblocks-w8": (dict(sparsity=0.5, bits=8, bk=4, bn=4),
                   "bsr_quant_matmul", "qblocks-w8"),
}


@pytest.mark.parametrize("tag", list(PACKED_CASES))
def test_packed_kernel_table(tag):
    """`core.kratos.PACKED_KERNELS` is the one table of each buffer
    format's kernel: `apply_packed` (on CPU tensors its wrapper's plain
    version) and `plain_packed` agree bitwise on leading axes, and the
    figures' kernel and format read the same kernel."""
    from repro_torch.core import kratos as kr
    kw, kernel, fmt = PACKED_CASES[tag]
    lin = kr.pack_linear({"w": torch.randn((16, 8), generator=_gen())},
                         kr.KratosSpec(**kw))
    x = torch.randn((2, 3, 16), generator=_gen())
    assert kr.packed_kernel(lin) == kernel
    assert common.packed_format(lin) == fmt
    assert common.kernel_of(lin, 6, 4).split("/")[0] == kernel
    got = kr.apply_packed(lin, x)
    assert got.shape == (2, 3, 8)
    assert torch.equal(got, kr.plain_packed(lin, x))
    _, plain, args = kr.PACKED_KERNELS[kernel]
    assert torch.equal(got.reshape(6, 8), plain(*args(lin, x.reshape(6, 16))))


def test_chip_smoke_takes_the_peaks_from_mesh():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_peaks",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.bound_ms(M.HBM_BW, 0.0, "float32") == (1000.0, "bytes")
    assert cs.bound_ms(0.0, 2 * M.PEAK_INT8_OPS, "int8") == \
        (2000.0, "operations")
    assert cs.TC_FLOPS == {"float32": M.PEAK_TF32_FLOPS / 3,
                           "bfloat16": M.PEAK_BF16_FLOPS}


def _figures(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.figures.run", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1", **(env or {})))


def test_figures_run_on_the_cpu():
    r = _figures("--device", "cpu", "--quick")
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    for claim in ("# C1 check", "# C2 check", "# C3 check", "# C4 check",
                  "# C5 check", "LINEAR ok", "not measured (no card)"):
        assert claim in out, claim
    assert "33.5 TMACs/s" in out          # the card's f32 ceiling


def test_figures_run_refuses_without_a_card():
    r = _figures("--quick", env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BS.BY_NAME))
def test_cuda_table_ii_points_match_plain(name):
    """Every Table II kernel at s 0 / 0.5 / 0.9 x bits None / 8 / 4 on the
    hand-written kernels: one launch of the wrapper its buffers select,
    held to the plain version of the same buffers (`common.point`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    for s in (0.0, 0.5, 0.9):
        for b in (None, 8, 4):
            spec = dataclasses.replace(BS.BY_NAME[name], sparsity=s, bits=b)
            pt = common.point(spec, "cuda")
            assert isinstance(pt["device_ms"], float) and \
                pt["max_abs_err"] <= 1e-3, (name, s, b, pt)

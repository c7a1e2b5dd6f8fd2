#!/usr/bin/env python3
"""Time this checkout's five GEMM kernels against another checkout's, on
one NVIDIA GPU.

    python3 gemm_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is a checkout of the repository (commit 3364f77 or one like it)
whose `dense_matmul_launch`, `quant_matmul_launch` and
`bsr_quant_matmul_launch` take the launch plan of `kernels/gemm_plan.py`
(this checkout's plan is handed to them), whose `bsr_matmul_launch` takes
none (the `gemm_tile.cuh` mainloop for every shape), and whose
`quant_matmul_w8a8_launch` takes int8 codes and row scales made outside
it: that side is timed together with `quantize_activations_int8`, so both
sides do the same work. Both checkouts' `csrc/dense_matmul.cu`,
`csrc/bsr_matmul.cu` and `csrc/quant_matmul.cu` are built with the same
nvcc flags; every case of `chip_smoke.py`'s phase-3 grid for the five
kernels (f32 and bf16, the h2o-danube shapes, falcon-mamba's x_proj for
the dense and quantized ones, m in 1, 8, 77, 512, codes of 8, 4, 2 and 1
bits, block sparsity 0.5 and 0.75) is then timed in turns, other / this /
this / other, with `chip_smoke.Timer` (L2 flushed, host work hidden), and
the two outputs are held to each other at the phase's tolerance. Prints
one line per case and the cases where this checkout is more than 5%
slower; writes chiprun_out/gemm_ab.json. Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

_c, _i = ctypes.c_void_p, ctypes.c_int


def build_other(other: Path, out_dir: Path, nvcc: str, flags) -> dict:
    """Build the other checkout's three GEMM sources, all nvccs at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in ("dense_matmul", "bsr_matmul", "quant_matmul"):
        out = out_dir / f"{name}.so"
        jobs[name] = (out, subprocess.Popen(
            # the other build's kernels get namespaces of their own, so the
            # two libraries in one process share no template symbol
            [nvcc, *flags, "-Dgk=gk_other", "-Drt=rt_other", "-o", str(out),
             str(other / "src" / "repro_torch" / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    dense = libs["dense_matmul"].dense_matmul_launch
    dense.argtypes = [_c, _c, _c] + [_i] * 10 + [_c]
    dense.restype = _i
    qt = libs["quant_matmul"].quant_matmul_launch
    qt.argtypes = [_c, _c, _c, _c] + [_i] * 11 + [_c]
    qt.restype = _i
    bsr = libs["quant_matmul"].bsr_quant_matmul_launch
    bsr.argtypes = [_c, _c, _c, _c, _c] + [_i] * 14 + [_c]
    bsr.restype = _i
    blocks = libs["bsr_matmul"].bsr_matmul_launch
    blocks.argtypes = [_c, _c, _c, _c] + [_i] * 7 + [_c]
    blocks.restype = _i
    w8a8 = libs["quant_matmul"].quant_matmul_w8a8_launch
    w8a8.argtypes = [_c, _c, _c, _c, _c] + [_i] * 4 + [_c]
    w8a8.restype = _i
    return {"dense": dense, "qt": qt, "bsr": bsr, "blocks": blocks,
            "w8a8": w8a8}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gemm_ab: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import kratos as kr
    from repro_torch.core import quantize as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import build, gemm_plan, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    build.build_all(["dense_matmul", "bsr_matmul", "quant_matmul",
                     "quant_matmul_w8a8"])
    old = build_other(other, ROOT / "build" / "gemm_ab", build.nvcc_path(),
                      build.NVCC_FLAGS)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def plan_args(pl):
        return (pl.form_id, pl.bm, pl.bn, pl.split, pl.k_per_split,
                pl.smem_bytes)

    def old_dense(x, w):
        m, n = x.shape
        p = w.shape[1]
        y = torch.empty((m, p), dtype=x.dtype, device="cuda")
        pl = gemm_plan.plan(m, n, p, elem=x.element_size())
        build.check(old["dense"](x.data_ptr(), w.data_ptr(), y.data_ptr(), m,
                                 n, p, int(x.dtype == torch.bfloat16),
                                 *plan_args(pl), stream()),
                    "other dense_matmul")
        return y

    def old_qt(x, qt):
        m, n = x.shape
        p = qt.shape[1]
        y = torch.empty((m, p), dtype=x.dtype, device="cuda")
        pl = gemm_plan.plan(m, n, p, bits=qt.bits, elem=x.element_size())
        build.check(old["qt"](x.data_ptr(), qt.data.data_ptr(),
                              qt.scale.data_ptr(), y.data_ptr(), m, n, p,
                              qt.bits, int(x.dtype == torch.bfloat16),
                              *plan_args(pl), stream()), "other quant_matmul")
        return y

    def old_bsr(x, qb, sc, idx, bits):
        m, n = x.shape
        n_pb, nnz, bkp, bn = qb.shape
        bk = bkp * (8 // bits)
        y = torch.empty((m, n_pb * bn), dtype=x.dtype, device="cuda")
        pl = gemm_plan.bsr_plan(m, n_pb, nnz, bk, bn, bits, x.element_size())
        build.check(old["bsr"](x.data_ptr(), qb.data_ptr(), sc.data_ptr(),
                               idx.data_ptr(), y.data_ptr(), m, n, n_pb, nnz,
                               bk, bn, bits, int(x.dtype == torch.bfloat16),
                               *plan_args(pl), stream()),
                    "other bsr_quant_matmul")
        return y

    def old_blocks(x, blocks, idx):
        m, n = x.shape
        n_pb, nnz, bk, bn = blocks.shape
        y = torch.empty((m, n_pb * bn), dtype=x.dtype, device="cuda")
        build.check(old["blocks"](x.data_ptr(), blocks.data_ptr(),
                                  idx.data_ptr(), y.data_ptr(), m, n, n_pb,
                                  nnz, bk, bn, int(x.dtype == torch.bfloat16),
                                  stream()), "other bsr_matmul")
        return y

    def old_w8a8(x, qt):
        m, n = x.shape
        p = qt.shape[1]
        xq, xs = qz.quantize_activations_int8(x)
        y = torch.empty((m, p), dtype=x.dtype, device="cuda")
        build.check(old["w8a8"](xq.data_ptr(), xs.data_ptr(),
                                qt.data.data_ptr(), qt.scale.data_ptr(),
                                y.data_ptr(), m, n, p,
                                int(x.dtype == torch.bfloat16), stream()),
                    "other quant_matmul_w8a8")
        return y

    print(f"card: {card}", flush=True)
    cases = []
    for dtype in cs.DTYPES:
        dt = getattr(torch, dtype)
        atol, rtol = cs.TOL[dtype]
        for n, p in cs.GEMM_SHAPES + [cs.XPROJ]:
            w32 = torch.randn((n, p), generator=gen, device="cuda") * n ** -0.5
            w = w32.to(dt)
            qts = {bits: qz.quantize(w32, bits) for bits in cs.BITS}
            sparse = []            # (sparsity, bits, qblocks, scales, idx)
            dense_blocks = []      # (sparsity, blocks, idx)
            if (n, p) != cs.XPROJ:
                for s in cs.SPARSITIES:
                    spec = kr.KratosSpec(sparsity=s)
                    plan = kr.plan_for(n, p, spec)
                    idx = torch.as_tensor(plan.indices, device="cuda")
                    dense_blocks.append((s, sp.pack_blocks(w, plan), idx))
                    for bits in cs.BITS:
                        buf = kr.pack({"w": w32}, spec.with_(bits=bits))
                        sparse.append((s, bits, buf["qblocks"],
                                       buf["qscale"], idx))
            for m in cs.GEMM_ROWS:
                x = torch.randn((m, n), generator=gen, device="cuda").to(dt)
                runs = [("dense_matmul", None, None, lambda: old_dense(x, w),
                         lambda: ops.matmul(x, w))]
                runs += [("quant_matmul", bits, None,
                          (lambda qt=qt: old_qt(x, qt)),
                          (lambda qt=qt: ops.quant_matmul(x, qt)))
                         for bits, qt in qts.items()]
                runs += [("bsr_quant_matmul", bits, s,
                          (lambda a=(qb, sc, idx, bits): old_bsr(x, *a)),
                          (lambda a=(qb, sc, idx, bits):
                           ops.bsr_quant_matmul(x, *a)))
                         for s, bits, qb, sc, idx in sparse]
                runs += [("bsr_matmul", None, s,
                          (lambda a=(blocks, idx): old_blocks(x, *a)),
                          (lambda a=(blocks, idx): ops.bsr_matmul(x, *a)))
                         for s, blocks, idx in dense_blocks]
                runs.append(("quant_matmul_w8a8", 8, None,
                             lambda: old_w8a8(x, qts[8]),
                             lambda: ops.quant_matmul_w8a8(x, qts[8])))
                for kernel, bits, sparsity, f_old, f_new in runs:
                    a, b = f_old(), f_new()
                    err = float((a.float() - b.float()).abs().max())
                    ok = bool(((a.float() - b.float()).abs()
                               <= atol + rtol * a.float().abs()).all())
                    t = [timer(f_old), timer(f_new), timer(f_new),
                         timer(f_old)]
                    case = dict(kernel=kernel, dtype=dtype, m=m, n=n, p=p,
                                bits=bits, sparsity=sparsity,
                                other_ms=min(t[0], t[3]),
                                this_ms=min(t[1], t[2]), turns_ms=t,
                                max_abs_diff=err, agree=ok)
                    case["ratio"] = case["this_ms"] / case["other_ms"]
                    cases.append(case)
                    print(f"  {kernel:16s} {dtype:8s} m={m:3d} {n}x{p} "
                          f"bits={bits} s={sparsity} other "
                          f"{case['other_ms']:.4f} ms, "
                          f"this {case['this_ms']:.4f} ms, ratio "
                          f"{case['ratio']:.3f}, |diff| {err:.3g}",
                          flush=True)
    slower = [c for c in cases if c["ratio"] > 1.05]
    disagree = [c for c in cases if not c["agree"]]
    print(f"cases {len(cases)}; more than 5% slower here: "
          f"{[(c['kernel'], c['dtype'], c['m'], c['n'], c['p'], c['bits'], c['sparsity'], round(c['ratio'], 3)) for c in slower]}; "
          f"outputs apart beyond tolerance: {len(disagree)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemm_ab.json").write_text(json.dumps(
        {"card": card, "other": str(other), "cases": cases}, indent=1))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

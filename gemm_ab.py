#!/usr/bin/env python3
"""Time this checkout's dense and weight-only GEMM kernels against another
checkout's, on one NVIDIA GPU.

    python3 gemm_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is a checkout of the repository whose `dense_matmul_launch`
and `quant_matmul_launch` take no launch plan (the single-tile mainloop of
`gemm_tile.cuh`). Both checkouts' `csrc/dense_matmul.cu` and
`csrc/quant_matmul.cu` are built with the same nvcc flags; every case of
`chip_smoke.py`'s phase-3 grid for the two kernels (f32 and bf16, the
h2o-danube shapes and falcon-mamba's x_proj, m in 1, 8, 77, 512, codes of
8, 4, 2 and 1 bits) is then timed in turns, other / this / this / other,
with `chip_smoke.Timer` (L2 flushed, host work hidden), and the two outputs
are held to each other at the phase's tolerance. Prints one line per case
and the cases where this checkout is more than 5% slower; writes
chiprun_out/gemm_ab.json. Exits non-zero without a GPU.
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
    """Build the other checkout's two GEMM sources, both nvccs at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in ("dense_matmul", "quant_matmul"):
        out = out_dir / f"{name}.so"
        jobs[name] = (out, subprocess.Popen(
            [nvcc, *flags, "-o", str(out),
             str(other / "src" / "repro_torch" / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    dense = libs["dense_matmul"].dense_matmul_launch
    dense.argtypes = [_c, _c, _c, _i, _i, _i, _i, _c]
    dense.restype = _i
    qt = libs["quant_matmul"].quant_matmul_launch
    qt.argtypes = [_c, _c, _c, _c, _i, _i, _i, _i, _i, _c]
    qt.restype = _i
    return {"dense": dense, "qt": qt}


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
    from repro_torch.core import quantize as qz
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    build.build_all(["dense_matmul", "quant_matmul"])
    old = build_other(other, ROOT / "build" / "gemm_ab", build.nvcc_path(),
                      build.NVCC_FLAGS)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_dense(x, w):
        m, n = x.shape
        p = w.shape[1]
        y = torch.empty((m, p), dtype=x.dtype, device="cuda")
        build.check(old["dense"](x.data_ptr(), w.data_ptr(), y.data_ptr(), m,
                                 n, p, int(x.dtype == torch.bfloat16),
                                 stream()), "other dense_matmul")
        return y

    def old_qt(x, qt):
        m, n = x.shape
        p = qt.shape[1]
        y = torch.empty((m, p), dtype=x.dtype, device="cuda")
        build.check(old["qt"](x.data_ptr(), qt.data.data_ptr(),
                              qt.scale.data_ptr(), y.data_ptr(), m, n, p,
                              qt.bits, int(x.dtype == torch.bfloat16),
                              stream()), "other quant_matmul")
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
            for m in cs.GEMM_ROWS:
                x = torch.randn((m, n), generator=gen, device="cuda").to(dt)
                runs = [("dense_matmul", None, lambda: old_dense(x, w),
                         lambda: ops.matmul(x, w))]
                runs += [("quant_matmul", bits,
                          (lambda qt=qt: old_qt(x, qt)),
                          (lambda qt=qt: ops.quant_matmul(x, qt)))
                         for bits, qt in qts.items()]
                for kernel, bits, f_old, f_new in runs:
                    a, b = f_old(), f_new()
                    err = float((a.float() - b.float()).abs().max())
                    ok = bool(((a.float() - b.float()).abs()
                               <= atol + rtol * a.float().abs()).all())
                    t = [timer(f_old), timer(f_new), timer(f_new),
                         timer(f_old)]
                    case = dict(kernel=kernel, dtype=dtype, m=m, n=n, p=p,
                                bits=bits, other_ms=min(t[0], t[3]),
                                this_ms=min(t[1], t[2]), turns_ms=t,
                                max_abs_diff=err, agree=ok)
                    case["ratio"] = case["this_ms"] / case["other_ms"]
                    cases.append(case)
                    print(f"  {kernel:13s} {dtype:8s} m={m:3d} {n}x{p} "
                          f"bits={bits} other {case['other_ms']:.4f} ms, "
                          f"this {case['this_ms']:.4f} ms, ratio "
                          f"{case['ratio']:.3f}, |diff| {err:.3g}",
                          flush=True)
    slower = [c for c in cases if c["ratio"] > 1.05]
    disagree = [c for c in cases if not c["agree"]]
    print(f"cases {len(cases)}; more than 5% slower here: "
          f"{[(c['kernel'], c['dtype'], c['m'], c['n'], c['p'], c['bits'], round(c['ratio'], 3)) for c in slower]}; "
          f"outputs apart beyond tolerance: {len(disagree)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemm_ab.json").write_text(json.dumps(
        {"card": card, "other": str(other), "cases": cases}, indent=1))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's, on one NVIDIA
GPU.

    python3 gemm_ab.py OTHER_CHECKOUT

OTHER_CHECKOUT is a checkout of the repository (commit a0e2a5b or a later
one) whose GEMM, flash, paged-attention and scan launchers take the
arguments this checkout's take: this checkout's wrappers drive both sides,
the other side through the other build's launch functions. The other
checkout's `csrc/dense_matmul.cu`, `bsr_matmul.cu`, `quant_matmul.cu`,
`quant_matmul_w8a8.cu`, `flash_attention.cu`, `paged_attention.cu` and
`ssm_scan.cu` are built with the same nvcc flags, their namespaces renamed
(`-Dgk=gk_other -Drt=rt_other`) so that both builds load in one process. Every case of `chip_smoke.py`'s phase-3 grid
for these kernels is then timed in turns, other / this / this / other, with
`chip_smoke.Timer` (L2 flushed, host work hidden): the five GEMMs (f32 and
bf16, the h2o-danube shapes, falcon-mamba's x_proj for the dense and
quantized ones, m in 1, 8, 77, 512, codes of 8, 4, 2 and 1 bits, block
sparsity 0.5 and 0.75), prefill flash attention (h2o-danube and
nemotron-4-340b heads), paged decode attention (8 slots, h2o-danube and
nemotron-4-340b heads, sq 1 and 3, window and softcap) and the scan
(falcon-mamba's d_inner 8192 at 1-512 positions, a ragged small case). The
two outputs are held to each other at the phase's tolerance, but w8a8's:
its activation scale became one FMA after commit 2a69b2e (the jitted
reference's), so its rows may quantize apart from an older side's, and
this side is held bit for bit to this checkout's plain version instead. Prints one
line per case and the cases where this checkout is more than 5% slower;
writes chiprun_out/gemm_ab.json. Exits non-zero without a GPU or where the
two outputs disagree.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OTHER_SOURCES = ("dense_matmul", "bsr_matmul", "quant_matmul",
                 "quant_matmul_w8a8", "flash_attention", "ssm_scan",
                 "paged_attention")



def build_other(other: Path, out_dir: Path, nvcc: str, flags) -> dict:
    """Build the other checkout's sources, all nvccs at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in OTHER_SOURCES:
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
    return libs


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
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core import kratos as kr
    from repro_torch.core import quantize as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import bsr_matmul as bsr_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import dense_matmul as dense_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as qmm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as scan_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    build.build_all()
    libs = build_other(other, ROOT / "build" / "gemm_ab", build.nvcc_path(),
                       build.NVCC_FLAGS)
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)

    # kernel -> (module, accessor, other source, launch function): each
    # wrapper runs the other side by swapping the module's accessor for the
    # other build's function
    same_abi = {
        "dense_matmul": (dense_mod, "_lib", "dense_matmul",
                         "dense_matmul_launch"),
        "bsr_matmul": (bsr_mod, "_lib", "bsr_matmul", "bsr_matmul_launch"),
        "quant_matmul": (qmm_mod, "_lib_qt", "quant_matmul",
                         "quant_matmul_launch"),
        "bsr_quant_matmul": (qmm_mod, "_lib_bsr", "quant_matmul",
                             "bsr_quant_matmul_launch"),
        "quant_matmul_w8a8": (qmm_mod, "_lib_w8a8", "quant_matmul_w8a8",
                              "quant_matmul_w8a8_launch"),
        "flash_attention": (fa_mod, "_lib", "flash_attention",
                            "flash_attention_launch"),
        "paged_flash_attention": (fa_mod, "_lib_paged", "paged_attention",
                                  "paged_attention_launch"),
        "ssm_scan": (scan_mod, "_lib", "ssm_scan", "ssm_scan_launch")}
    other_fn = {}
    for kernel, (mod, attr, source, name) in same_abi.items():
        mine = getattr(mod, attr)()
        fn = getattr(libs[source], name)
        fn.argtypes, fn.restype = mine.argtypes, mine.restype
        other_fn[kernel] = fn

    def on_other(kernel, call):
        """`call` with the kernel's wrapper launching the other build."""
        mod, attr, _, _ = same_abi[kernel]
        mine = getattr(mod, attr)

        def run():
            setattr(mod, attr, lambda: other_fn[kernel])
            try:
                return call()
            finally:
                setattr(mod, attr, mine)
        return run

    print(f"card: {card}", flush=True)
    cases = []

    def flat(out):
        if isinstance(out, tuple):      # the scan's (y, h)
            return torch.cat([out[0].float().flatten(), out[1].flatten()])
        return out

    def ab(kernel, dtype, tol, f_old, f_new, want=None, **shape):
        """Time f_old against f_new in turns; their outputs agree within
        `tol`, or with `want`, f_new's equals it bit for bit."""
        a, b = flat(f_old()), flat(f_new())
        atol, rtol = tol
        diff = (a.float() - b.float()).abs()
        ok = bool((diff <= atol + rtol * a.float().abs()).all()) \
            if want is None else torch.equal(b, want)
        t = [timer(f_old), timer(f_new), timer(f_new), timer(f_old)]
        case = dict(kernel=kernel, dtype=dtype, **shape,
                    other_ms=min(t[0], t[3]), this_ms=min(t[1], t[2]),
                    turns_ms=t, max_abs_diff=float(diff.max()), agree=ok)
        case["ratio"] = case["this_ms"] / case["other_ms"]
        cases.append(case)
        print(f"  {kernel:21s} {dtype:8s} {json.dumps(shape)} other "
              f"{case['other_ms']:.4f} ms, this {case['this_ms']:.4f} ms, "
              f"ratio {case['ratio']:.3f}, |diff| {case['max_abs_diff']:.3g}",
              flush=True)

    def ab_same(kernel, dtype, tol, call, **shape):
        ab(kernel, dtype, tol, on_other(kernel, call), call, **shape)

    # the five GEMMs
    for dtype in cs.DTYPES:
        dt = getattr(torch, dtype)
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
                gemm = dict(m=m, n=n, p=p)
                ab_same("dense_matmul", dtype, cs.TOL[dtype],
                        lambda: ops.matmul(x, w), **gemm)
                for bits, qt in qts.items():
                    ab_same("quant_matmul", dtype, cs.TOL[dtype],
                            lambda qt=qt: ops.quant_matmul(x, qt), bits=bits,
                            **gemm)
                for s, bits, qb, sc, idx in sparse:
                    ab_same("bsr_quant_matmul", dtype, cs.TOL[dtype],
                            lambda a=(qb, sc, idx, bits):
                            ops.bsr_quant_matmul(x, *a), bits=bits,
                            sparsity=s, **gemm)
                for s, blocks, idx in dense_blocks:
                    ab_same("bsr_matmul", dtype, cs.TOL[dtype],
                            lambda a=(blocks, idx): ops.bsr_matmul(x, *a),
                            sparsity=s, **gemm)
                call = lambda: ops.quant_matmul_w8a8(x, qts[8])
                ab("quant_matmul_w8a8", dtype, cs.TOL[dtype],
                   on_other("quant_matmul_w8a8", call), call,
                   want=ref.quant_matmul_w8a8_ref(x, qts[8]), bits=8,
                   **gemm)

    # prefill flash attention
    for dtype in cs.DTYPES:
        dt = getattr(torch, dtype)
        for heads, d, sqs, caps in ((32, 80, (16, 77, 512), (None, 50.0)),
                                    (96, 192, (77, 512), (None,))):
            for sq in sqs:
                q, k, v = (torch.randn((1, hh, sq, d), generator=gen,
                                       device="cuda").to(dt)
                           for hh in (heads, 8, 8))
                for window in (None, 64):
                    for cap in caps:
                        ab_same("flash_attention", dtype, cs.FA_TOL[dtype],
                                lambda kw=dict(window=window, softcap=cap):
                                ops.flash_attention(q, k, v, **kw), sq=sq,
                                heads=heads, d=d, window=window, softcap=cap)

    # paged decode attention: 8 slots over a shuffled pool, slot 3 idle on
    # the sink page
    b, page = 8, 16
    for dtype in cs.DTYPES:
        dt = getattr(torch, dtype)
        for heads, d, pp in ((32, 80, 34), (96, 192, 48)):
            n_pages = b * pp + 1
            kp, vp = (torch.randn((n_pages, 8, page, d), generator=gen,
                                  device="cuda").to(dt) for _ in range(2))
            table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                     + 1).reshape(b, pp).to(torch.int32)
            table[3] = 0
            last = torch.randint(pp * page // 4, pp * page, (b,),
                                 generator=gen, device="cuda").to(torch.int32)
            for sq in (1, 3):
                q = torch.randn((b, heads, sq, d), generator=gen,
                                device="cuda").to(dt)
                for window in (None, 64):
                    for cap in (None, 50.0):
                        ab_same("paged_flash_attention", dtype,
                                cs.FA_TOL[dtype],
                                lambda kw=dict(window=window, softcap=cap):
                                ops.paged_attention(q, kp, vp, table, last,
                                                    **kw),
                                heads=heads, d=d, pages_per_slot=pp, sq=sq,
                                window=window, softcap=cap)

    # the selective scan, inputs drawn as chip_smoke.py draws them
    def n_(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    for dtype in cs.DTYPES:
        dt = getattr(torch, dtype)
        for bsz, s, di, st in ((1, 1, 8192, 16), (1, 7, 8192, 16),
                               (1, 64, 8192, 16), (1, 512, 8192, 16),
                               (2, 33, 128, 8)):
            args = [x.to(dt) for x in (
                n_(bsz, s, di) * 0.5,
                torch.nn.functional.softplus(n_(bsz, s, di) - 1.0),
                n_(bsz, s, st) * 0.5, n_(bsz, s, st) * 0.5)]
            args.append(-torch.exp(n_(di, st) * 0.3))
            ab_same("ssm_scan", dtype, cs.SSM_TOL[dtype],
                    lambda a=args: ops.ssm_scan(*a), batch=bsz, s=s,
                    d_inner=di, d_state=st)

    slower = [c for c in cases if c["ratio"] > 1.05]
    disagree = [c for c in cases if not c["agree"]]
    by_kernel = {}
    for c in cases:
        by_kernel.setdefault(c["kernel"], []).append(c["ratio"])
    for kernel, r in by_kernel.items():
        print(f"{kernel}: {len(r)} cases, this / other {min(r):.3f}-"
              f"{max(r):.3f} (median {float(np.median(r)):.3f})", flush=True)
    print(f"cases {len(cases)}; more than 5% slower here: "
          f"{[(c['kernel'], c['dtype'], {k: v for k, v in c.items() if k in ('m', 'n', 'p', 'bits', 'sparsity', 'sq', 'd', 's', 'd_inner', 'window', 'softcap')}, round(c['ratio'], 3)) for c in slower]}; "
          f"outputs apart beyond tolerance: {len(disagree)}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gemm_ab.json").write_text(json.dumps(
        {"card": card, "other": str(other), "cases": cases}, indent=1))
    return 1 if disagree else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Table III / Fig. 8 reproduction: the granularity case study (port of
`benchmarks/table3_tilesweep.py`).

Paper claim (C4): sweeping FPGA LUT size K in {3..6} shows ~2x silicon-area
saving at K=3, and K=3 wins the area-delay product for nearly all kernels —
the fabric granularity should match the workload.

The granularity knob is the sparsity block g. For a weight with true
unstructured (element-level) sparsity a g x g block must be kept if any
element in it is nonzero, so coarse g carries dead weights inside kept
blocks (the 'big LUT' waste), and fine g pays in launch shape and
per-block overhead. `kept_frac` is measured from magnitude-pruned weights
exactly as in the JAX package. The JAX package models the TPU's 128 x 128
systolic padding (`mxu_pad`) for `hw_macs_frac` and `t_model_us`; that
model does not carry over and no GPU padding model stands in for it
(`hw_macs_frac` is `-`). On the card `t_model_us` is `bsr_matmul` timed
at grain g x g with nnz = round(kept_frac x n / g) kept blocks a block
column, m = 128 bf16 rows, and `adp` / `adp_norm` are `vmem_bytes` times
that time; on the CPU those columns are `-`. `vmem_bytes` is the JAX
package's formula for the TPU block step's on-chip footprint, not a
footprint of the card's kernels: the ADP multiplies a TPU area proxy by a
GPU time, and its grain ranking on the card follows the launch form each
grain gets (`kernel_form`), not the footprint.

  PYTHONPATH=src python -m repro_torch.figures.table3_tilesweep [--bits 8] [--quick] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.figures.common import (CSV, DASH, SEED, fmt_ms, on_card,
                                        require_device)
from repro_torch.kernels import gemm_plan, ops, ref

GRAIN = (8, 16, 32, 64, 128, 256)
SPARSITY = (0.7, 0.8, 0.9, 0.95, 0.98)
BM = 128                       # activation rows of one call


def kept_fraction(mask: np.ndarray, g: int) -> float:
    """Fraction of g x g blocks containing at least one nonzero."""
    n, p = mask.shape
    blocks = mask[:n // g * g, :p // g * g].reshape(n // g, g, p // g, g)
    alive = blocks.any(axis=(1, 3))
    return float(alive.mean())


def grain_operands(n: int, p: int, g: int, nnz: int, device,
                   gen: torch.Generator, rng: np.random.Generator):
    """bsr_matmul's operands at grain g: x (BM, n) and nnz random kept
    (g, g) blocks per block column (sorted int32 indices), bf16."""
    n_kb, n_pb = n // g, p // g
    idx = np.stack([np.sort(rng.permutation(n_kb)[:nnz])
                    for _ in range(n_pb)]).astype(np.int32)
    blocks = (torch.randn((n_pb, nnz, g, g), generator=gen, device=device)
              * n ** -0.5).to(torch.bfloat16)
    x = torch.randn((BM, n), generator=gen, device=device).to(torch.bfloat16)
    return x, blocks, torch.as_tensor(idx, device=device)


def run(n: int = 2048, p: int = 2048, bits: int = 8, seed: int = SEED,
        quick: bool = False, *, device="cuda") -> dict:
    device = require_device(device)
    if quick:
        n, p = min(n, 1024), min(p, 1024)
    sparsities = SPARSITY[::2] if quick else SPARSITY
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, p)).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    csv = CSV(["sparsity", "grain", "kept_frac", "eff_macs_frac",
               "hw_macs_frac", "vmem_bytes", "t_model_us", "adp",
               "adp_norm", "device_ms", "bound_ms", "kernel_form"])
    best = {}
    for s in sparsities:
        thr = np.quantile(np.abs(w), s)
        mask = np.abs(w) > thr            # magnitude pruning -> unstructured
        rows = []
        for g in GRAIN:
            kf = kept_fraction(mask, g)
            nnz = max(1, int(round(kf * n / g)))
            args = grain_operands(n, p, g, nnz, device, gen, rng)
            form = gemm_plan.bsr_plan(BM, p // g, nnz, g, g, 0, 2).form
            pt = on_card(ops.bsr_matmul, args, ref.bsr_matmul_ref,
                         wrapper="bsr_matmul", dtype=torch.bfloat16,
                         flops=2.0 * BM * nnz * g * p)
            vmem = BM * g * 2 + g * g * bits // 8 + BM * g * 4
            ms = pt["device_ms"]
            t_us = ms * 1e3 if isinstance(ms, float) else DASH
            adp = vmem * t_us * 1e-6 if isinstance(ms, float) else DASH
            rows.append((g, kf, vmem, t_us, adp, ms, pt["bound_ms"],
                         f"bsr_matmul/{form}"))
        timed = [r for r in rows if isinstance(r[4], float)]
        min_adp = min(r[4] for r in timed) if timed else None
        for g, kf, vmem, t_us, adp, ms, bound, kernel in rows:
            csv.row(s, g, kf, kf, DASH, vmem, t_us, adp,
                    adp / min_adp if min_adp else DASH, fmt_ms(ms), bound,
                    kernel)
        if timed:
            best[s] = min(timed, key=lambda r: r[4])[0]
    waste = kept_fraction(np.abs(w) > np.quantile(np.abs(w), 0.95), 256) \
        / (1 - 0.95)
    if best:
        print("\n# C4 check: ADP-optimal grain per sparsity on the card:",
              best, "(ADP = the TPU block step's footprint formula x the "
              "card's time; the ranking follows the launch form, not the "
              "footprint)")
    else:
        print("\n# C4 check: ADP-optimal grain per sparsity: not measured "
              "(no card)")
    print("# paper: smallest LUT (K=3) wins ADP for sparse kernels; here the")
    print("# grain trades kept dead weights against the launch form the")
    print("# block shape gets, and coarse 256-grain blocks pay up to "
          f"{waste:.1f}x the ideal MACs at 95% sparsity — the 'big LUT' "
          "waste.")
    return {"csv": csv.records(), "best_grain": best}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    run(bits=a.bits, quick=a.quick, device=a.device)


if __name__ == "__main__":
    main()

"""Multi-pod dry-run: count every (arch x shape) cell's step on the
production mesh, per device, without a card (port of
`repro.launch.dryrun`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \
      --shape train_4k [--multi-pod] [--out results.jsonl]

The JAX package forces 512 XLA host devices, lowers and compiles each
cell's step under its shardings and reads the compiled program. Here a
fake process group of 256 ranks (512 with --multi-pod; `launch.mesh.
fake_world`) carries the same 16 x 16 or 2 x 16 x 16 mesh in this one
process; the cell's inputs are meta tensors (`launch.shapes`) placed by
the port's placement (`distributed.sharding.input_shardings`: parameters
and the train state whole on every rank, batches split by rows over
('pod', 'data'), decode caches split by kv heads or Mamba channels over
'model'), and rank 0's step runs once on its blocks under
`analysis.dispatch_cost`, which counts its ops, bytes, collectives and
peak live bytes. Nothing is allocated and no kernel launches: the count
is the plain path's, as the JAX package lowers `backend="ref"`.

The record has the JAX package's keys, so one table reads both ledgers,
less its two TPU-only ones (`hlo_bytes_tpu_adjusted`,
`xla_cost_analysis_flops_unscaled`):
  * `lower_s` times building the cell's inputs and step and placing them
    (the JAX package's trace and lower), `compile_s` the counted call
    (there, XLA's compile);
  * `hlo_flops_per_device` / `hlo_bytes_per_device` / `collectives` are
    rank 0's counts (`dispatch_cost.analyze`'s keys);
  * `mem_argument_size_in_bytes` / `mem_output_size_in_bytes` are the
    bytes of rank 0's input and output blocks, `mem_temp_size_in_bytes`
    the call's peak live bytes beside them; `fits_hbm` says whether
    arguments and temporaries fit `launch.mesh.HBM_BYTES`.
A cell whose step cannot run on shapes alone is an error, never skipped.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tu
from repro_torch.analysis import dispatch_cost as DC
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as M
from repro_torch.launch import shapes as SP

# the warnings a variant flag adds where the port's placement moves no count
TP2D_WARNING = ("serve_tp2d: the 'dm_in' -> 'data' override shards no leaf "
                "(the port's step replicates parameters, ROADMAP.md §3); "
                "only 'batch' -> None moves the counts: every rank decodes "
                "every row")
BF16_WARNING = ("bf16_reduce: the port's step has no row-parallel psum to "
                "narrow (parameters replicated, ROADMAP.md §3); only the "
                "plain products' accumulation dtype changes")


def input_shardings(kind: str, args, mesh, cell):
    """The cell's step inputs placed as the port places them
    (`distributed.sharding.input_shardings`)."""
    return SH.input_shardings(kind, args, mesh, cell)


def output_shardings(kind: str, in_sh, mesh, cell):
    """The step's outputs placed as its inputs are
    (`distributed.sharding.output_shardings`)."""
    return SH.output_shardings(kind, in_sh, mesh, cell)


def _local(args, shardings):
    """Meta tensors of rank 0's block of every input (a replicated leaf is
    the leaf itself)."""
    def block(x, sh):
        shape = SH.shard_shape(sh.spec, tuple(x.shape), sh.mesh)
        if shape == tuple(x.shape):
            return x
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return tu.tree_map(block, args, shardings)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tu.leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             cfg_overrides: Optional[Dict] = None,
             save_hlo: Optional[str] = None, serve_tp2d: bool = False,
             bf16_reduce: bool = False) -> Dict[str, Any]:
    cell = SP.SHAPES_BY_NAME[shape]
    ok, reason = SP.cell_applicable(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    n_ranks = 512 if multi_pod else 256
    with M.fake_world(n_ranks):
        mesh = M.make_production_mesh(multi_pod=multi_pod, device="meta")
        axes = SH.mesh_axes(mesh)
        n_chips = math.prod(axes.values())
        dp = math.prod(axes[a] for a in ("pod", "data") if a in axes)
        cfg = SP.config_for_dryrun(arch, **(cfg_overrides or {}))
        t0 = time.time()
        kind, args = SP.cell_inputs(arch, cell, cfg=cfg)
        step = SP.make_step_fn(arch, cell, cfg=cfg, mesh_dp=dp, mesh=mesh)

        warnings = []
        rule_overrides = None
        if serve_tp2d and kind == "decode":
            rule_overrides = {"batch": None, "dm_in": "data"}
            warnings.append(TP2D_WARNING)
        accum = kref._DOT_ACCUM
        if bf16_reduce:
            kref.set_dot_accum(torch.bfloat16)
            warnings.append(BF16_WARNING)
        try:
            with SH.use_mesh(mesh, rule_overrides):
                in_sh = input_shardings(kind, args, mesh, cell)
                local = _local(args, in_sh)
                t_lower = time.time() - t0
                t1 = time.time()
                out, mode = DC.count(step, *local, keep_ops=bool(save_hlo))
                t_compile = time.time() - t1
                if kind != "train":     # rank 0's block of the logits
                    out_sh = output_shardings(kind, in_sh, mesh, cell)
                    want = SH.shard_shape(out_sh[0].spec,
                                          (cell.batch, 1, cfg.vocab), mesh)
                    assert tuple(out[0].shape) == want, (out[0].shape, want)
        finally:
            kref.set_dot_accum(accum)

    analysis = mode.result()
    if save_hlo:
        with open(save_hlo, "w") as f:
            for row in mode.ops:
                f.write(json.dumps(row) + "\n")
    mem_args = _bytes(local)
    mem_temp = int(analysis["peak_bytes"])
    return {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "status": "ok", "kind": kind, "n_chips": n_chips,
        "seq": cell.seq, "batch": cell.batch,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "hlo_flops_per_device": analysis["flops"],
        "hlo_bytes_per_device": analysis["bytes"],
        "collectives": {
            "counts": {k: v["count"] for k, v in
                       analysis["collectives"].items()},
            "result_bytes": {k: v["bytes"] for k, v in
                             analysis["collectives"].items()},
            "wire_bytes_per_device": analysis["wire_bytes"],
        },
        "analysis_warnings": warnings + analysis["warnings"],
        "params": int(cfg.param_count()),
        "active_params": int(cfg.active_param_count()),
        "mem_argument_size_in_bytes": mem_args,
        "mem_output_size_in_bytes": _bytes(out),
        "mem_temp_size_in_bytes": mem_temp,
        "fits_hbm": mem_args + mem_temp <= M.HBM_BYTES,
    }


def roofline_terms(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The three roofline terms (seconds) from a dry-run record, at the
    card's data-sheet peaks (`launch.mesh`): bf16 tensor-core FLOPs, HBM
    bytes and NVLink wire bytes one way."""
    if rec.get("status") != "ok":
        return {}
    flops = rec["hlo_flops_per_device"]
    bytes_ = rec["hlo_bytes_per_device"]
    wire = rec["collectives"]["wire_bytes_per_device"]
    t_compute = flops / M.PEAK_BF16_FLOPS
    t_memory = bytes_ / M.HBM_BW
    t_coll = wire / M.NVLINK_BW
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll}
    dom = max(terms, key=terms.get)
    # useful model FLOPs: 6 N D per trained token; decode/prefill: 2 N D
    n = rec["active_params"]
    toks = rec["batch"] * (rec["seq"] if rec["kind"] != "decode" else 1)
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * n * toks / rec["n_chips"]   # per device
    terms.update({
        "dominant": dom.replace("t_", "").replace("_s", ""),
        "model_flops_per_device": model_flops,
        "useful_flops_fraction": model_flops / flops if flops > 0 else None,
        "roofline_fraction":
            (model_flops / M.PEAK_BF16_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else None,
    })
    return terms


def parse_kratos(text: str):
    """'sparsity=0.9,bits=8,impl=tree,bk=128,bn=128' -> KratosSpec."""
    from repro_torch.core import kratos as kr
    kw = {}
    for part in text.split(","):
        k, v = part.split("=")
        kw[k] = v if k in ("impl", "unroll") else (
            float(v) if k == "sparsity" else int(v))
    return kr.KratosSpec(**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=[s.name for s in SP.SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON record here")
    ap.add_argument("--save-hlo", default=None,
                    help="write the counted op trace here (one JSON line "
                         "per op: shapes, dtypes, FLOPs, bytes)")
    ap.add_argument("--serve-tp2d", action="store_true",
                    help="decode cells: the JAX package's 2D-TP rule "
                         "override (batch replicated, dm_in over 'data')")
    ap.add_argument("--bf16-reduce", action="store_true",
                    help="bf16 accumulation of the plain projection products")
    ap.add_argument("--kratos", default=None,
                    help="attach a KratosSpec, e.g. 'sparsity=0.9,bits=8'")
    args = ap.parse_args(argv)

    overrides = {}
    if args.kratos:
        overrides["kratos"] = parse_kratos(args.kratos)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   save_hlo=args.save_hlo, cfg_overrides=overrides,
                   serve_tp2d=args.serve_tp2d, bf16_reduce=args.bf16_reduce)
    rec["variant"] = {k: v for k, v in
                      (("serve_tp2d", args.serve_tp2d),
                       ("bf16_reduce", args.bf16_reduce),
                       ("kratos", args.kratos)) if v}
    rec["roofline"] = roofline_terms(rec)
    if args.out:                       # persist before stdout (SIGPIPE-safe)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()

"""Training launcher (port of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --steps 200 --batch 8 --seq 64 --ckpt-dir build/ckpt \
      [--device cuda|cpu] [--full] [--sparsity 0.5 --bits 8] [--compress] \
      [--fail-at N] [--grad-accum G]

It takes the JAX launcher's flags and prints its `[train]` lines. It
trains on the card (`--device cuda`, the default; without a GPU it
refuses) or, with `--device cpu`, through the same plain path on the CPU;
the reduced smoke config by default, the published one with `--full`.
Checkpoints are written in the JAX package's layout and a rerun with the
same --ckpt-dir resumes from the latest one (the JAX package's too), so
a directory that already holds the last step runs no step: empty it to
start over.
`--mesh local` (the default) trains data-parallel over every rank of the
process group when the launcher runs under torchrun (`torchrun
--nproc-per-node N -m repro_torch.launch.train ...`: a (N, 1) mesh, each
rank on its block of every batch's rows, gradients averaged over 'data',
rank 0 writing the checkpoints); run alone it is one rank and the same as
`none`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import List, Optional

from repro_torch import configs as C
from repro_torch.core import kratos as kr
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import compression as GC
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.optim import adamw as O
from repro_torch.serve.registry import check_device
from repro_torch.train import TrainLoopConfig, run_training


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="the reduced config (the default; see --full)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--bits", type=int, default=0)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="failure injection (chaos drill)")
    ap.add_argument("--data", default="markov", choices=["markov", "uniform"])
    ap.add_argument("--mesh", default="local", choices=["local", "none"])
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    device = check_device(args.device)
    mesh = None
    if args.mesh == "local" and M.join_torchrun(device):
        import torch.distributed as dist
        mesh = M.make_local_mesh(dist.get_world_size(), 1, device=device)
    cfg = (C.get_config if args.full else C.get_smoke)(args.arch)
    if args.sparsity or args.bits:
        spec = kr.KratosSpec(sparsity=args.sparsity,
                             bits=args.bits or None, bk=8, bn=8)
        cfg = dataclasses.replace(cfg, kratos=spec)
        print(f"[train] kratos spec: {spec}")
        rep = kr.cost_report(cfg.d_model, cfg.d_ff or cfg.d_model, spec)
        print(f"[train] per-projection cost: {rep['mac_fraction']:.2f} MACs, "
              f"{rep['weight_bytes_fraction']:.2f} weight bytes vs dense")

    opt_cfg = O.OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps),
                                total_steps=args.steps)
    data_cfg = DataConfig(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq, source=args.data,
        frames=cfg.enc_positions if cfg.enc_dec else 0,
        d_model=cfg.d_model, img_tokens=cfg.n_img_tokens)
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           fail_at_step=args.fail_at,
                           grad_accum=args.grad_accum)
    compress = GC.ef_int8_compress if args.compress else None
    with SH.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        out = run_training(cfg, opt_cfg, data_cfg, loop,
                           compress_fn=compress, device=device)

    losses = [h["loss"] for h in out["history"]]
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"over {len(losses)} steps (resumed_from={out['resumed_from']})")


if __name__ == "__main__":
    main()

"""Quickstart: train a small LM with the Kratos technique attached (the
PyTorch port of `examples/quickstart.py`).

Shows the three things this framework is about:
  1. a model config with a KratosSpec (50% block-sparse + 8-bit weights)
     on every projection,
  2. a real training loop on a learnable synthetic task (loss drops),
  3. the per-projection cost report: compute/bytes vs the dense model
     (the paper's 'area' saving).

  PYTHONPATH=src python examples_torch/quickstart.py [--device cuda|cpu] \
      [--full]

Runs on the card by default (refused without one); `--device cpu` runs
the same training on the CPU. `--full` trains h2o-danube-1.8b's published
config (full width and depth) where the default is the smoke config. The train step runs on the reference path,
so no hand-written kernel is launched.
"""

import argparse
import dataclasses
import math
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as C
from repro_torch.core import kratos as kr
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw as O
from repro_torch.serve.registry import check_device
from repro_torch.train import TrainLoopConfig, run_training

SPEC = kr.KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)
STEPS = 150


def config(full=False):
    cfg = (C.get_config if full else C.get_smoke)("h2o-danube-1.8b")
    return dataclasses.replace(cfg, kratos=SPEC)


def run(device="cuda", *, full=False, ckpt_dir=None):
    """Train h2o-danube (the smoke config, or with `full` the published
    one) under SPEC for STEPS steps.

    ckpt_dir: a directory holding a step-0 checkpoint (the port's layout
    or the JAX package's) to start from in place of the seed's init; the
    run trains in a copy of it, so the directory is left as it was."""
    device = check_device(device)
    cfg = config(full)
    work = tempfile.mkdtemp(prefix="kratos_qs_") if ckpt_dir else None
    try:
        if work:
            shutil.copytree(ckpt_dir, work, dirs_exist_ok=True)
        out = run_training(
            cfg,
            O.OptimizerConfig(lr=2e-3, warmup_steps=20, total_steps=STEPS),
            DataConfig(vocab=cfg.vocab, batch=8, seq=32, source="markov"),
            TrainLoopConfig(steps=STEPS, log_every=25, ckpt_dir=work),
            device=device)
    finally:
        if work:
            shutil.rmtree(work, ignore_errors=True)
    return {"spec": SPEC, "cost": kr.cost_report(cfg.d_model, cfg.d_ff, SPEC),
            "vocab": cfg.vocab, "losses": [h["loss"] for h in out["history"]]}


def main(argv=None, **run_kw):
    """Parse the flags, train, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    a = ap.parse_args(argv)
    check_device(a.device)
    cfg = config(a.full)
    rep = kr.cost_report(cfg.d_model, cfg.d_ff, SPEC)
    print(f"kratos spec: {SPEC}")
    print(f"per-projection vs dense: {rep['mac_fraction']:.2f}x MACs, "
          f"{rep['weight_bytes_fraction']:.2f}x weight bytes\n")
    out = run(a.device, full=a.full, **run_kw)
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(irreducible ~ noise entropy; uniform would be ln V = "
          f"{math.log(cfg.vocab):.2f})")
    assert losses[-1] < losses[0] - 1.0, "training did not learn!"
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()

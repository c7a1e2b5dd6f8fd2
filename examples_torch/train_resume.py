"""Fault-tolerance drill: train, crash mid-run, resume, verify equivalence
(the PyTorch port of `examples/train_resume.py`).

Demonstrates the restart story end to end:
  * checkpoints are atomic (tmp+rename) and written asynchronously, in the
    JAX package's layout,
  * the data pipeline is step-indexed, so the resumed run consumes exactly
    the batches a never-failed run would have,
  * the resumed run's final loss matches an uninterrupted reference run
    bit for bit.

  PYTHONPATH=src python examples_torch/train_resume.py [--device cuda|cpu]

On the card the three runs go under torch.use_deterministic_algorithms:
without it the embedding's backward adds with atomics and the resumed
losses part from the reference's in the last bits. The train step runs on
the reference path, so no hand-written kernel is launched.
"""

import argparse
import contextlib
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw as O
from repro_torch.serve.registry import check_device
from repro_torch.train import SimulatedFailure, TrainLoopConfig, run_training

STEPS, CKPT_EVERY, FAIL_AT = 40, 10, 23


@contextlib.contextmanager
def deterministic(device):
    """Deterministic kernels on the card; nothing to do on the CPU."""
    if device.type != "cuda":
        yield
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def run(device="cuda", *, ckpt_dir=None):
    """The reference run, the run that crashes at FAIL_AT and its resume.

    ckpt_dir: a directory holding a step-0 checkpoint to start from in
    place of the seed's init; each run starts from its own copy, so the
    directory is left as it was."""
    device = check_device(device)
    cfg = C.get_smoke("gemma2-27b")
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=STEPS)
    data = DataConfig(vocab=cfg.vocab, batch=4, seq=24, seed=11)
    refdir = tempfile.mkdtemp(prefix="kratos_ref_") if ckpt_dir else None
    ckdir = tempfile.mkdtemp(prefix="kratos_ck_")
    if ckpt_dir:
        shutil.copytree(ckpt_dir, refdir, dirs_exist_ok=True)
        shutil.copytree(ckpt_dir, ckdir, dirs_exist_ok=True)
    crash = None
    try:
        with deterministic(device):
            print("=== reference run (no failure) ===")
            ref = run_training(cfg, opt, data, TrainLoopConfig(
                steps=STEPS, log_every=10, ckpt_dir=refdir), device=device)

            print(f"\n=== run with injected failure at step {FAIL_AT} ===")
            try:
                run_training(cfg, opt, data, TrainLoopConfig(
                    steps=STEPS, ckpt_dir=ckdir, ckpt_every=CKPT_EVERY,
                    log_every=10, fail_at_step=FAIL_AT), device=device)
            except SimulatedFailure as e:
                crash = str(e)
                print(f"!! crashed as injected: {e}")

            print("\n=== resume (same command, auto-restores latest "
                  "checkpoint) ===")
            out = run_training(cfg, opt, data, TrainLoopConfig(
                steps=STEPS, ckpt_dir=ckdir, ckpt_every=CKPT_EVERY,
                log_every=10), device=device)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        if refdir:
            shutil.rmtree(refdir, ignore_errors=True)
    return {"crash": crash, "resumed_from": out["resumed_from"],
            "reference_losses": [h["loss"] for h in ref["history"]],
            "resumed_losses": [h["loss"] for h in out["history"]]}


def main(argv=None, **run_kw):
    """Parse the flags, drill, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, **run_kw)
    print(f"resumed from step {out['resumed_from']}")
    ref_loss = out["reference_losses"][-1]
    res_loss = out["resumed_losses"][-1]
    print(f"\nfinal loss — reference: {ref_loss:.6f}, resumed: {res_loss:.6f}")
    assert out["crash"] is not None, "the injected failure did not fire"
    assert np.isclose(ref_loss, res_loss, rtol=0, atol=0), "NOT bitwise equal"
    print("bitwise-identical resume OK")
    return out


if __name__ == "__main__":
    main()

"""The paper's motivating tradeoff, end-to-end: accuracy vs efficiency
across sparsity x precision on a real (small) training task (the PyTorch
port of `examples/sparsity_sweep.py`).

Trains the same model at {dense, 50%, 90%} sparsity x {f32, 8, 4}-bit
weights on the learnable markov task, and prints final loss next to the
compute/byte cost of each point: the accuracy-efficiency frontier the
paper's §V trends feed into (its ref [53]: 'pruning vs quantization').

  PYTHONPATH=src python examples_torch/sparsity_sweep.py [--steps 120] \
      [--device cuda|cpu] [--full]

Runs on the card by default (refused without one). `--full` trains
h2o-danube-1.8b's published config (full width and depth) where the
default is the smoke config. The train step runs on
the reference path, so no hand-written kernel is launched.
"""

import argparse
import dataclasses
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

# (sparsity, bits): bits None keeps the float weights
GRID = [(0.0, None), (0.5, None), (0.9, None),
        (0.0, 8), (0.0, 4), (0.5, 8), (0.9, 4)]


def run(device="cuda", *, steps=120, full=False, ckpt_dir=None):
    """Train every GRID point for `steps` steps (the smoke h2o-danube, or
    with `full` the published config); one row per point.

    ckpt_dir: a directory holding a step-0 checkpoint to start every point
    from in place of the seed's init (each point trains in its own copy,
    so the directory is left as it was)."""
    device = check_device(device)
    base = (C.get_config if full else C.get_smoke)("h2o-danube-1.8b")
    rows = []
    for s, bits in GRID:
        spec = kr.KratosSpec(sparsity=s, bits=bits, bk=8, bn=8)
        cfg = dataclasses.replace(base, kratos=spec)
        work = tempfile.mkdtemp(prefix="kratos_sw_") if ckpt_dir else None
        try:
            if work:
                shutil.copytree(ckpt_dir, work, dirs_exist_ok=True)
            out = run_training(
                cfg, O.OptimizerConfig(lr=2e-3, warmup_steps=10,
                                       total_steps=steps),
                DataConfig(vocab=cfg.vocab, batch=8, seq=32, seed=3),
                TrainLoopConfig(steps=steps, log_every=0, ckpt_dir=work),
                device=device)
        finally:
            if work:
                shutil.rmtree(work, ignore_errors=True)
        rows.append({"sparsity": s, "bits": bits,
                     "losses": [h["loss"] for h in out["history"]],
                     "cost": kr.cost_report(cfg.d_model, cfg.d_ff, spec)})
    return {"steps": steps, "rows": rows}


def main(argv=None, **run_kw):
    """Parse the flags, sweep, print; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, steps=a.steps, full=a.full, **run_kw)
    print(f"{'sparsity':>8} {'bits':>5} {'final_loss':>10} "
          f"{'mac_frac':>9} {'byte_frac':>9}")
    for r in out["rows"]:
        print(f"{r['sparsity']:>8.1f} {r['bits'] or 16:>5} "
              f"{r['losses'][-1]:>10.4f} "
              f"{r['cost']['mac_fraction']:>9.2f} "
              f"{r['cost']['weight_bytes_fraction']:>9.2f}")
    print("sparsity_sweep OK")
    return out


if __name__ == "__main__":
    main()

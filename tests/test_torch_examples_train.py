"""Port parity, the training examples: `examples_torch/quickstart.py`,
`sparsity_sweep.py` and `train_resume.py` against `examples/`'s, on the
CPU. Both sides start from the JAX package's init state, carried into the
port as a step-0 checkpoint in the JAX layout (each example's
`ckpt_dir`). Each port `main` runs with its own assertions, train_resume
at its own size, the sweep at --steps 3 (its one flag) and quickstart at
50 of its 150 steps (the time each takes here); the losses of the first
10 steps equal JAX's `run_training` on the example's configs within rtol
1e-5, the train step tests' tolerance."""

import dataclasses

import numpy as np
import pytest

from torch_examples import load, one_torch_thread  # noqa: F401

import jax

from repro import configs as JC
from repro.checkpoint.manager import CheckpointManager
from repro.core import kratos as jkr
from repro.data.pipeline import DataConfig
from repro.distributed import steps as JST
from repro.optim import adamw as JO
from repro.train import TrainLoopConfig, run_training

N_CMP = 10          # leading steps compared with JAX's
RTOL = 1e-5         # the train step tests' loss tolerance
SWEEP_STEPS = 3
QUICKSTART_STEPS = 50


def step0(path, cfg, opt):
    """Save JAX's PRNGKey(0) train state for (cfg, opt) as step 0."""
    CheckpointManager(str(path)).save(
        0, JST.init_train_state(jax.random.PRNGKey(0), cfg, opt))
    return str(path)


def jax_losses(cfg, opt, data, steps, ckpt_dir=None):
    out = run_training(cfg, opt, data, TrainLoopConfig(
        steps=steps, log_every=0, ckpt_dir=ckpt_dir))
    return [h["loss"] for h in out["history"]]


def test_quickstart_matches_jax(tmp_path, capsys, monkeypatch):
    """The JAX quickstart's config (smoke h2o-danube under s0.5-w8 on 8 x 8
    blocks), cut from 150 to QUICKSTART_STEPS steps (the whole run takes
    ~35 s on one CPU thread); the port's run still learns (main asserts
    that the loss falls by more than 1.0)."""
    ex = load("quickstart")
    assert ex.STEPS == 150
    monkeypatch.setattr(ex, "STEPS", QUICKSTART_STEPS)
    spec = jkr.KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)
    assert dataclasses.asdict(ex.SPEC) == dataclasses.asdict(spec)
    cfg = dataclasses.replace(JC.get_smoke("h2o-danube-1.8b"), kratos=spec)
    opt = JO.OptimizerConfig(lr=2e-3, warmup_steps=20,
                             total_steps=QUICKSTART_STEPS)
    want = jax_losses(cfg, opt, DataConfig(vocab=cfg.vocab, batch=8, seq=32,
                                           source="markov"), N_CMP)
    out = ex.main(["--device", "cpu"], ckpt_dir=step0(tmp_path, cfg, opt))
    assert len(out["losses"]) == QUICKSTART_STEPS
    np.testing.assert_allclose(out["losses"][:N_CMP], want, rtol=RTOL)
    rep = jkr.cost_report(cfg.d_model, cfg.d_ff, spec)
    assert out["cost"] == rep
    printed = capsys.readouterr().out
    assert "quickstart OK" in printed
    assert (f"per-projection vs dense: {rep['mac_fraction']:.2f}x MACs, "
            f"{rep['weight_bytes_fraction']:.2f}x weight bytes") in printed


def test_sparsity_sweep_matches_jax(tmp_path):
    """Every grid point from one step-0 state (the dense init), JAX's
    `run_training` restoring the same checkpoint; the cost columns
    exactly JAX's `cost_report`."""
    ex = load("sparsity_sweep")
    base = JC.get_smoke("h2o-danube-1.8b")
    opt = JO.OptimizerConfig(lr=2e-3, warmup_steps=10,
                             total_steps=SWEEP_STEPS)
    init = step0(tmp_path / "init", base, opt)
    out = ex.main(["--steps", str(SWEEP_STEPS), "--device", "cpu"],
                  ckpt_dir=init)
    assert [(r["sparsity"], r["bits"]) for r in out["rows"]] == ex.GRID
    for i, row in enumerate(out["rows"]):
        spec = jkr.KratosSpec(sparsity=row["sparsity"], bits=row["bits"],
                              bk=8, bn=8)
        cfg = dataclasses.replace(base, kratos=spec)
        work = tmp_path / f"jax{i}"
        CheckpointManager(str(work)).save(
            0, CheckpointManager(init).restore(
                JST.init_train_state(jax.random.PRNGKey(0), cfg, opt))[0])
        want = jax_losses(cfg, opt, DataConfig(vocab=cfg.vocab, batch=8,
                                               seq=32, seed=3),
                          SWEEP_STEPS, ckpt_dir=str(work))
        np.testing.assert_allclose(row["losses"], want, rtol=RTOL,
                                   err_msg=str(spec))
        assert row["cost"] == jkr.cost_report(cfg.d_model, cfg.d_ff, spec)


def test_train_resume_matches_jax(tmp_path, capsys):
    """Smoke gemma2 (the JAX drill's config): the reference run's leading
    losses equal JAX's; the port's crash at step 23 resumes from step 20
    and ends bitwise on the reference's final loss (main asserts it)."""
    ex = load("train_resume")
    cfg = JC.get_smoke("gemma2-27b")
    opt = JO.OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    want = jax_losses(cfg, opt, DataConfig(vocab=cfg.vocab, batch=4, seq=24,
                                           seed=11), N_CMP)
    out = ex.main(["--device", "cpu"], ckpt_dir=step0(tmp_path, cfg, opt))
    np.testing.assert_allclose(out["reference_losses"][:N_CMP], want,
                               rtol=RTOL)
    assert out["resumed_from"] == 20
    assert out["crash"] == "injected failure at step 23"
    assert out["resumed_losses"][-1] == out["reference_losses"][-1]
    assert "bitwise-identical resume OK" in capsys.readouterr().out

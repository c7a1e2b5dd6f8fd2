"""The training loop: checkpointed, restartable, failure-injectable (port
of `repro.train.loop`).

  * every step is `distributed.steps.make_train_step` over (state, batch),
    its forward on the reference path, its update in place;
  * batches are a pure function of (seed, step) (`data.pipeline`), so a
    restart consumes exactly the stream a never-failed run would have;
  * checkpoints are atomic (tmp + rename), written off-thread by default,
    in the JAX package's layout (`checkpoint.manager.save_train_state`);
  * `run_training` always begins by restoring the latest checkpoint if one
    exists (the port's or the JAX package's): crash recovery and a
    planned restart are the same path. It restores into the structure of
    a fresh state, as the reference does, so a compression residual
    ("comp") is not restored;
  * `fail_at_step` raises SimulatedFailure AFTER the step runs and BEFORE
    its checkpoint: the worst crash window.

On the CPU a crash and resume equals the uninterrupted run bit for bit.
Restoring onto another device layout (`state_shardings`) is item 11.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import manager as CM
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.distributed import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O
from repro_torch.serve.registry import check_device


class SimulatedFailure(RuntimeError):
    """Injected crash (tests / chaos drills)."""


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    async_checkpoint: bool = True
    fail_at_step: Optional[int] = None      # failure injection
    grad_accum: int = 1
    seed: int = 0


def run_training(cfg: T.ModelConfig, opt_cfg: O.OptimizerConfig,
                 data_cfg: DataConfig, loop: TrainLoopConfig,
                 *, state_shardings=None, compress_fn=None,
                 on_step: Optional[Callable[[int, Dict], None]] = None,
                 device="cuda") -> Dict[str, Any]:
    """Train (or resume) to loop.steps on `device` (the card unless the
    caller asks for the CPU). Returns {'state', 'history',
    'resumed_from'}."""
    if state_shardings is not None:
        raise NotImplementedError(
            "state_shardings restores onto a device mesh: ROADMAP.md queue "
            "1, item 11 (multi-device)")
    device = check_device(device)
    pipe = make_pipeline(data_cfg)
    step_fn = ST.make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum,
                                 compress_fn=compress_fn)
    mgr = CM.CheckpointManager(loop.ckpt_dir, keep=loop.keep) \
        if loop.ckpt_dir else None

    state = ST.init_train_state(loop.seed, cfg, opt_cfg, device=device)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, start = CM.restore_train_state(mgr, state, cfg)
        print(f"[train] resumed from checkpoint step {start}")

    history: List[Dict[str, float]] = []
    t0 = time.time()
    try:
        for step in range(start, loop.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.batch(step).items()}
            state, metrics = step_fn(state, batch)
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            history.append(m)
            if on_step is not None:
                on_step(step + 1, m)
            if loop.log_every and (step + 1) % loop.log_every == 0:
                rate = (step + 1 - start) / (time.time() - t0)
                print(f"[train] step {step+1}/{loop.steps} "
                      f"loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f} "
                      f"({rate:.2f} it/s)")
            if loop.fail_at_step is not None and (step + 1) == loop.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step+1}")
            if mgr is not None and (step + 1) % loop.ckpt_every == 0:
                CM.save_train_state(mgr, step + 1, state, cfg,
                                    metadata={"loss": m["loss"]},
                                    blocking=not loop.async_checkpoint)
    finally:
        # a failure lets an async writer finish, as it would in a process
        # that lives on
        if mgr is not None:
            mgr.wait()
    if mgr is not None and loop.steps % loop.ckpt_every != 0 \
            and loop.steps > start:
        CM.save_train_state(mgr, loop.steps, state, cfg)
    return {"state": state, "history": history, "resumed_from": start}

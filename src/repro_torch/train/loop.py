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

Under a mesh (`distributed.sharding.use_mesh`, as the JAX package's
launcher runs it) the loop is data-parallel over 'data': each rank steps
on its block of every batch's rows, the step averages the gradients over
'data', and the state stays whole on every rank; rank 0 writes the
checkpoints, blocking, the other ranks waiting at a barrier.
`state_shardings` places the restored state on the mesh (each rank reads
its block of every leaf, `checkpoint.manager.restore_train_state`); the
data-parallel step gathers every leaf whole again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.checkpoint import manager as CM
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.distributed import sharding as SH
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
    device = check_device(device)
    mesh = SH.current_mesh()
    rows, writer = _data_rows(mesh, data_cfg.batch)
    pipe = make_pipeline(data_cfg)
    step_fn = ST.make_train_step(cfg, opt_cfg, grad_accum=loop.grad_accum,
                                 compress_fn=compress_fn, mesh=mesh)
    mgr = CM.CheckpointManager(loop.ckpt_dir, keep=loop.keep) \
        if loop.ckpt_dir else None
    save = _saver(mgr, cfg, mesh, writer, loop.async_checkpoint)

    state = ST.init_train_state(loop.seed, cfg, opt_cfg, device=device)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        state, start = CM.restore_train_state(mgr, state, cfg,
                                              shardings=state_shardings)
        if state_shardings is not None:
            # the data-parallel step runs on whole leaves
            state = tu.tree_map(lambda t: t.full_tensor(), state)
        print(f"[train] resumed from checkpoint step {start}")

    history: List[Dict[str, float]] = []
    t0 = time.time()
    try:
        for step in range(start, loop.steps):
            batch = {k: torch.from_numpy(v[rows]).to(device)
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
                save(step + 1, state, {"loss": m["loss"]})
    finally:
        # a failure lets an async writer finish, as it would in a process
        # that lives on
        if mgr is not None:
            mgr.wait()
    if mgr is not None and loop.steps % loop.ckpt_every != 0 \
            and loop.steps > start:
        save(loop.steps, state, None, blocking=True)
    return {"state": state, "history": history, "resumed_from": start}


def _data_rows(mesh, batch: int) -> Tuple[slice, bool]:
    """(this rank's rows of every batch, whether it writes checkpoints):
    all rows and True without a mesh; on a mesh, its block over 'data'
    and True on rank 0 only."""
    if mesh is None:
        return slice(None), True
    import torch.distributed as dist
    axes = SH.mesh_axes(mesh)
    n = axes.get("data", 1)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over data={n}")
    i = SH.coordinate(mesh).get("data", 0)
    per = batch // n
    return slice(i * per, (i + 1) * per), dist.get_rank() == 0


def _saver(mgr, cfg, mesh, writer: bool, async_checkpoint: bool):
    """save(step, state, metadata, blocking=None): the writer saves (off
    the thread unless asked, or on a mesh, where every rank then waits at
    a barrier so a restore on any rank sees the file)."""
    def save(step, state, metadata, blocking=None):
        if mgr is None:
            return
        if blocking is None:
            blocking = mesh is not None or not async_checkpoint
        if writer:
            CM.save_train_state(mgr, step, state, cfg, metadata=metadata,
                                blocking=blocking)
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier()
    return save

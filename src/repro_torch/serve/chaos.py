"""Deterministic fault injection for the serve stack (port of
`repro.serve.chaos`).

A `ChaosHarness` wraps a `ReplicaRouter` and fires a schedule of faults (an
explicit `Fault` list, or `seeded_schedule` for a reproducible
pseudo-random storm) at exact router steps, between dispatches — never
mid-dispatch, so every run with the same seed and schedule injects
identically: every unfinished request completes on a survivor or sheds
with an explicit terminal state, pools drain to pristine, and the greedy
outputs of a failed-over run equal a fault-free run's.

Fault kinds (all injected at the host/device boundary):

  crash          the replica's decode dispatch raises ReplicaFault from
                 then on: the router marks it dead, evacuates it and
                 optionally restarts it.
  nan_logits     ONE decode sync returns out-of-vocab tokens (what an
                 argmax over NaN logits degenerates to after an int cast):
                 the engine's sync validation must refuse to emit them and
                 raise ReplicaFault.
  pool_squeeze   confiscates free pages of a paged pool for `duration`
                 steps: admission sees PoolExhausted (pool-wait backoff and
                 shed paths) while resident requests keep decoding. A slab
                 pool has no pages: the squeeze raises ValueError.
  slow_dispatch  each decode dispatch sleeps `delay_s` for `duration`
                 steps: wall latency degrades, the step clock does not.

The injectors shadow the target replica's backend methods
(`decode_block`, `spec_decode_block`) with instance attributes and undo
them by restoring what was there (dropping the shadow where the class's
method showed through), so no bound method of a backend is left stored on
it: that cycle would keep a restarted replica's backend, and its CUDA
graph pool, alive.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import ReplicaFault
from repro_torch.serve.router import ReplicaRouter

FAULT_KINDS = ("crash", "nan_logits", "pool_squeeze", "slow_dispatch")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled injection: `kind` fires on replica `replica` just
    before router step `step` runs; `duration` (steps) bounds the window
    for the reversible kinds. `pages` / `delay_s` parameterize
    pool_squeeze / slow_dispatch."""

    kind: str
    step: int
    replica: int = 0
    duration: int = 1
    pages: int = 0            # pool_squeeze: free pages to confiscate
    delay_s: float = 0.0      # slow_dispatch: sleep per dispatch

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")


def seeded_schedule(seed: int, n_steps: int, n_replicas: int, *,
                    kinds: Sequence[str] = FAULT_KINDS,
                    rate: float = 0.05) -> Tuple[Fault, ...]:
    """Reproducible pseudo-random fault storm: same (seed, n_steps,
    n_replicas, kinds, rate) -> byte-identical schedule, every draw off
    one seeded Generator."""
    rng = np.random.default_rng(seed)
    faults: List[Fault] = []
    for step in range(2, n_steps):
        if rng.random() < rate:
            kind = kinds[int(rng.integers(len(kinds)))]
            faults.append(Fault(
                kind=kind, step=step,
                replica=int(rng.integers(n_replicas)),
                duration=int(rng.integers(1, 4)),
                pages=int(rng.integers(1, 8)),
                delay_s=float(rng.uniform(0.001, 0.01))))
    return tuple(faults)


def _shadow(obj, name: str, fn: Callable) -> Callable[[], None]:
    """Shadow `obj.<name>` with `fn`; returns the undo, which restores what
    `obj` held before (deleting the shadow where the class's method showed
    through)."""
    held = vars(obj)
    had, prev = name in held, held.get(name)
    setattr(obj, name, fn)

    def undo():
        if had:
            setattr(obj, name, prev)
        else:
            held.pop(name, None)
    return undo


class ChaosHarness:
    """Drive a router step-by-step, firing scheduled faults between
    dispatches. `injected` records every fault actually armed (tests
    assert against it)."""

    def __init__(self, router: ReplicaRouter,
                 faults: Sequence[Fault]) -> None:
        self.router = router
        self.faults = sorted(faults, key=lambda f: (f.step, f.replica))
        self.injected: List[Fault] = []
        self._active: List[Tuple[Fault, Callable[[], None]]] = []

    def step(self) -> None:
        """Expire elapsed faults, arm the ones due, then one router step."""
        upcoming = self.router.step_count + 1
        for entry in list(self._active):
            f, undo = entry
            if f.step + f.duration <= upcoming:
                undo()
                self._active.remove(entry)
        for f in self.faults:
            if f.step == upcoming:
                undo = self._inject(f)
                self.injected.append(f)
                if undo is not None:
                    self._active.append((f, undo))
        self.router.step()

    def run(self, max_steps: Optional[int] = None):
        """router.run(), but through the fault clock; restores any still-
        active reversible fault afterwards so pool invariants can be
        asserted on the drained fleet."""
        rt = self.router
        limit = max_steps if max_steps is not None else \
            10 * sum(r.max_new_tokens + 2 for r in rt.requests) \
            + max([r.arrival_step for r in rt.requests], default=0) \
            + 10 * len(self.faults) + 10
        try:
            while rt.n_waiting or rt.n_active:
                if not any(rt.alive):
                    raise RuntimeError(
                        "every replica is dead with work remaining — "
                        "enable auto_restart or shrink the schedule")
                if limit <= 0:
                    raise RuntimeError(
                        "chaos run did not drain within the step limit")
                self.step()
                limit -= 1
        finally:
            for _, undo in self._active:
                undo()
            self._active.clear()
        return {i: list(r.generated) for i, r in enumerate(rt.requests)}

    # -------------------------------------------------------------- injectors

    def _inject(self, f: Fault) -> Optional[Callable[[], None]]:
        eng = self.router.replicas[f.replica]
        be = eng.backend
        if f.kind == "crash":
            def raiser(*a, **k):
                raise ReplicaFault(
                    f"chaos: injected crash (replica {f.replica}, "
                    f"step {f.step})")
            _shadow(be, "decode_block", raiser)
            _shadow(be, "spec_decode_block", raiser)
            return None      # permanent: the patched backend dies with
            #                  the replica (failover/restart replaces it)

        if f.kind == "nan_logits":
            # one-shot: the NEXT sync returns out-of-vocab tokens, exactly
            # what `int32(argmax(NaN logits))` degenerates to; the engine's
            # validation must catch it BEFORE any emission side effect
            b = eng.cfg.n_slots
            if eng.cfg.speculate:
                k = eng.cfg.speculate

                def bad_spec(*a, **kw):
                    undo()
                    return (np.full((b, k + 1), -1, np.int32),
                            np.full((b,), k + 1, np.int32),
                            np.zeros((b,), np.int32))
                undo = _shadow(be, "spec_decode_block", bad_spec)
            else:
                k = eng.cfg.decode_chunk

                def bad_block(*a, **kw):
                    undo()
                    return np.full((k, b), -1, np.int32)
                undo = _shadow(be, "decode_block", bad_block)
            return None      # self-restoring after one sync

        if f.kind == "pool_squeeze":
            pool = eng.pool
            if not hasattr(pool, "_free_pages"):
                raise ValueError(
                    "pool_squeeze targets a paged pool "
                    "(EngineConfig.page_size); replica "
                    f"{f.replica} runs a slab")
            n = min(f.pages or len(pool._free_pages),
                    len(pool._free_pages))
            taken = [pool._free_pages.pop() for _ in range(n)]

            def undo_squeeze():
                pool._free_pages.extend(reversed(taken))
            return undo_squeeze

        if f.kind == "slow_dispatch":
            orig = be.decode_block

            def slow(*a, **k):
                time.sleep(f.delay_s)
                return orig(*a, **k)
            return _shadow(be, "decode_block", slow)

        raise AssertionError(f.kind)     # Fault.__post_init__ guards this

"""Admission scheduling (port of `repro.serve.scheduler`).

`ContinuousScheduler`: a waiting request gets a cache slot whenever one is
free, at most `max_prefills_per_step` admissions (each one a prefill) per
engine step, so new arrivals do not starve in-flight decodes. With a
K-step decode dispatch the admission clock ticks once per K-token block.
`StaticScheduler` is the lock-step baseline: it admits a whole wave into
the free slots only once every slot has drained. An engine takes any
`SchedulerBase` (`InferenceEngine(..., scheduler=)`); `admissible` is
called once per step with the arrived requests, the active slot count and
the free slot count, and returns the prefix to admit."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request and its engine-managed lifecycle state."""

    id: int
    prompt: np.ndarray                      # (S0,) int32 token ids
    max_new_tokens: int
    arrival_step: int = 0                   # simulated-trace admission gate
    temperature: float = 0.0                # 0 => greedy
    eos_id: Optional[int] = None
    # per-request model inputs besides the tokens, batch-1 leading: a
    # vision-stub arch's {"img_embeds": (1, n_img_tokens, d)}, or an
    # encoder-decoder's {"frames": (1, enc_positions, d)}
    extras: Optional[Dict[str, Any]] = None
    on_token: Optional[Callable[["Request", int], None]] = None  # streaming
    # per-request speculation cap on a speculating engine: the most draft
    # tokens a dispatch may accept for it (None = the engine's K, 0 = opt
    # out: the slot takes one plain target step a dispatch)
    speculate: Optional[int] = None
    # QoS and deadlines (serve.qos): `deadline_steps` counts engine steps
    # from arrival_step (the deterministic clock); `deadline_ms` is a wall
    # bound from submit (perf_counter). Either sheds the request once it
    # cannot finish in time: at admission, in the queue, or mid-flight
    # with its slot and pages freed. `slo` is a free-form class label.
    deadline_steps: Optional[int] = None
    deadline_ms: Optional[float] = None
    slo: str = ""

    # engine-managed
    state: str = "waiting"                  # waiting | running | done | shed
    slot: int = -1
    index: int = 0                          # next cache write position
    generated: List[int] = dataclasses.field(default_factory=list)
    prefix_matched: int = 0                 # prompt tokens reused (paged)
    # why a "shed" request ended: 'deadline' | 'pool' | 'failover' |
    # 'cancel'
    shed_reason: str = ""
    # the cheapest (highest) engine tier this request decoded on
    tier: int = 0
    # PoolExhausted backoff (EngineConfig.pool_wait_retries): requeues so
    # far and the earliest step the admission may be tried again
    pool_retries: int = 0
    retry_at_step: int = 0
    # the dead replica a request was evacuated from (serve.router); the
    # adopting engine counts the failover once and resets it
    failover_from: int = -1

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def finished(self) -> bool:
        """Terminal either way: completed ('done') or shed ('shed')."""
        return self.state in ("done", "shed")

    def deadline_step(self) -> Optional[int]:
        """The deadline on the absolute step clock, or None."""
        if self.deadline_steps is None:
            return None
        return self.arrival_step + self.deadline_steps


def replica_load(n_active: int, n_free: int, n_waiting: int) -> int:
    """The admission-side load signal of the replica router (serve.router):
    committed work minus immediately available capacity. A replica with
    free slots and an empty queue scores negative (it can admit now); one
    with a backed-up queue scores by its depth."""
    return n_active + n_waiting - n_free


class SchedulerBase:
    name = "base"

    def admissible(self, arrived: List[Request], n_active: int,
                   n_free: int) -> List[Request]:
        raise NotImplementedError


class ContinuousScheduler(SchedulerBase):
    """Admit in arrival order whenever a slot is free; returns a prefix of
    `arrived` and never mutates it."""

    name = "continuous"

    def __init__(self, max_prefills_per_step: int = 1):
        self.max_prefills_per_step = max_prefills_per_step

    def admissible(self, arrived: List[Request], n_active: int,
                   n_free: int) -> List[Request]:
        return arrived[:min(len(arrived), n_free, self.max_prefills_per_step)]


class StaticScheduler(SchedulerBase):
    """Drain before refill: nothing is admitted while a slot is active."""

    name = "static"

    def admissible(self, arrived: List[Request], n_active: int,
                   n_free: int) -> List[Request]:
        if n_active > 0:
            return []
        return arrived[:n_free]

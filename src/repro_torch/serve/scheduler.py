"""Admission scheduling (port of `repro.serve.scheduler`, continuous
policy): a waiting request gets a cache slot whenever one is free, at most
one admission (each one a prefill) per engine step, so new arrivals do not
starve in-flight decodes. With a K-step decode dispatch the admission clock
ticks once per K-token block."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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

    # engine-managed
    state: str = "waiting"                  # waiting | running | done
    slot: int = -1
    index: int = 0                          # next cache write position
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.state == "done"


class ContinuousScheduler:
    """Admit in arrival order whenever a slot is free; returns a prefix of
    `arrived` and never mutates it."""

    max_prefills_per_step = 1

    def admissible(self, arrived: List[Request], n_free: int) -> List[Request]:
        return arrived[:min(len(arrived), n_free, self.max_prefills_per_step)]

"""Slab KV-cache pool with per-request slot assignment (port of
`repro.serve.cache_pool`).

One `transformer.make_caches(cfg, n_slots, max_len)` slab is allocated on
the device at construction and never reallocated. A request takes a free
slot (one batch row of every layer's cache), its prefilled batch-1 cache is
copied into that row, and the row returns to the free list when the
request completes. Decode runs over the whole slab; per-slot validity
masks keep stale rows inert, so freeing is O(1) bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.models import transformer as T


class PoolExhausted(RuntimeError):
    """No free cache slot: the scheduler must hold the request in the queue."""


class CachePool:
    """Fixed-slot KV pool; slots are reused LIFO (hot rows stay hot)."""

    def __init__(self, cfg: T.ModelConfig, n_slots: int, max_len: int,
                 dtype=torch.float32, device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.caches: List[Dict[str, torch.Tensor]] = T.make_caches(
            cfg, n_slots, max_len, dtype, device)
        self._free: List[int] = list(range(n_slots - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.n_slots} cache slots in use; admission must wait")
        return self._free.pop()

    def free(self, slot: int) -> None:
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"double-free of slot {slot}")
        self._free.append(slot)

    def write_slot(self, slot: int, single: List[Dict[str, torch.Tensor]]) -> None:
        """Copy a prefilled batch-1 cache list into row `slot` of the slab."""
        for row, one in zip(self.caches, single):
            for name, t in row.items():
                t[slot].copy_(one[name][0])

"""Slab KV-cache pool with per-request slot assignment (port of
`repro.serve.cache_pool`).

One `transformer.make_caches(cfg, n_slots, max_len)` slab is allocated on
the device at construction and never reallocated. A request takes a free
slot (one batch row of every layer's cache), its prefilled batch-1 cache is
copied into that row, and the row returns to the free list when the
request completes. Decode runs over the whole slab; per-slot validity
masks keep stale rows inert, so freeing is O(1) bookkeeping.

With `mesh=` (serve.backend.ShardedBackend) each rank allocates only its
shard of every leaf, as `distributed.sharding.cache_pspecs(slab=True)`
places it: its block of slot rows over 'data', its kv heads (or Mamba
channels) over 'model'; `rows` is the (first slot, count) it holds, and
`write_slot` copies its part of a prefilled row, or nothing when another
rank holds the slot. The slot bookkeeping stays whole on every rank.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.serve.trace import NULL_TRACER


class PoolExhausted(RuntimeError):
    """No free cache slot: the scheduler must hold the request in the queue."""


class CachePool:
    """Fixed-slot KV pool; slots are reused LIFO (hot rows stay hot)."""

    # the engine re-points this at its Tracer when tracing is on
    tracer = NULL_TRACER

    def __init__(self, cfg: T.ModelConfig, n_slots: int, max_len: int,
                 dtype=torch.float32, device="cuda", *, mesh=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.mesh = mesh
        template = T.make_caches(cfg, n_slots, max_len, dtype, "meta")
        self._bytes = sum(t.numel() * t.element_size()
                          for row in template for t in row.values())
        self.shardings = None
        self.rows = (0, n_slots)
        if mesh is None:
            self.caches: List[Dict[str, torch.Tensor]] = T.make_caches(
                cfg, n_slots, max_len, dtype, device)
        else:
            specs = SH.cache_pspecs(template, mesh, n_slots, slab=True)
            self.shardings = [{n: SH.NamedSharding(mesh, s)
                               for n, s in layer.items()} for layer in specs]
            self._slices = [{n: sh.local_slices(template[i][n].shape)
                             for n, sh in layer.items()}
                            for i, layer in enumerate(self.shardings)]
            self.caches = [{n: torch.zeros(
                tuple(s.stop - s.start for s in self._slices[i][n]),
                dtype=dtype, device=device) for n in layer}
                for i, layer in enumerate(template)]
            first = self._slices[0][next(iter(template[0]))][0]
            self.rows = (first.start, first.stop - first.start)
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
        """Copy a prefilled batch-1 cache list into row `slot` of the slab
        (on a mesh: this rank's part of it, if this rank holds the slot)."""
        lo, n = self.rows
        if not lo <= slot < lo + n:
            return
        for li, (row, one) in enumerate(zip(self.caches, single)):
            for name, t in row.items():
                src = one[name][0]
                if self.shardings is not None:
                    src = src[self._slices[li][name][1:]]
                t[slot - lo].copy_(src)

    def bytes(self) -> int:
        """Bytes of the slab: every cache tensor of every layer (on a mesh,
        of the whole slab, as the JAX package's sharded array counts)."""
        return self._bytes

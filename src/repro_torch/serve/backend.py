"""Execution backend: where the serving steps run (the `LocalBackend` of
`repro.serve.backend`, slab and native paged forms).

The backend owns the KV slab or page pool, the device-resident loop state
and the prefill / decode steps; the engine owns request lifecycle. On a CUDA
device every decode dispatch runs under
`torch.cuda.set_sync_debug_mode("error")`, so any host synchronisation
inside the K micro-steps raises instead of silently stalling the loop; the
(K, B) token block is copied out after the guard — the dispatch's one
host sync. The sharded and multi-process backends are not ported yet
(ROADMAP.md queue 1, item 11).

Contract (what the engine calls):
  build(model, cfg)              allocate pool/state, make the steps
  prefill(batch, exact)          -> (logits, batch-1 caches) on the device
  write_slot(slot, caches)       copy a prefilled row into the slab
  first_token(row, temperature)  sample the prefill token (one host sync)
  install(slot, ...)             write the slot's row of the loop state
  decode_block()                 ONE dispatch of K micro-steps; returns the
                                 (K, B) int32 block as numpy
  release_slot(slot)             park a slot's loop-state row inert
and the paged admission surface (no-ops on the slab pool): `paged`,
`prefix_match`, `alloc_slot_pages`, `prefix_insert`,
`conversation_insert`, `page_stats`, `prefill_suffix`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.distributed import steps as ST
from repro_torch.models import transformer as T
from repro_torch.serve.cache_pool import CachePool
from repro_torch.serve.paging import PagedCachePool


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """Make any synchronising CUDA call inside the block raise."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class LocalBackend:
    """Single-device placement: slab or page pool + fused K-step decode
    loop."""

    name = "local"

    def build(self, model, cfg) -> None:
        self.model, self.cfg = model, cfg
        self.params = model.params
        self.device = torch.device(cfg.device)
        mcfg = model.cfg
        cdtype = getattr(torch, cfg.cache_dtype)
        kw = dict(cache_len=cfg.max_len, cache_dtype=cdtype, device=self.device)
        self._prefill_last = ST.make_prefill_step(mcfg, True, **kw)
        self._prefill_full = ST.make_prefill_step(mcfg, False, **kw)
        if cfg.page_size:
            self.pool = PagedCachePool(
                mcfg, cfg.n_slots, cfg.max_len, cdtype, self.device,
                page_size=cfg.page_size, n_pages=cfg.n_pages,
                prefix_cache=cfg.prefix_cache)
            self._decode = ST.make_paged_decode_step(
                mcfg, n_steps=cfg.decode_chunk, layout=self.pool.layout)
            if self.pool.index is not None:
                self._suffix_prefill = ST.make_suffix_prefill_step(
                    mcfg, layout=self.pool.layout)
        else:
            self.pool = CachePool(mcfg, cfg.n_slots, cfg.max_len, cdtype,
                                  self.device)
            self._decode = ST.make_decode_step(mcfg,
                                               n_steps=cfg.decode_chunk)
        self.state = ST.make_decode_state(cfg.n_slots, cfg.seed, self.device)
        self._first_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def prefill(self, batch: Dict[str, Any], exact: bool):
        fn = self._prefill_last if exact else self._prefill_full
        return fn(self.params, batch)

    def write_slot(self, slot: int, caches) -> None:
        self.pool.write_slot(slot, caches)

    def first_token(self, row: torch.Tensor, temperature: float) -> int:
        temp = torch.full((1,), temperature, dtype=torch.float32,
                          device=self.device)
        return int(T.sample_tokens(row, self._first_gen, temp)[0])

    def install(self, slot: int, token: int, index: int, temperature: float,
                eos: int, remaining: int) -> None:
        ST.install_slot(self.state, slot, token, index, temperature, eos,
                        remaining)

    def release_slot(self, slot: int) -> None:
        """Park a slot's loop-state row inert (remaining 0): the fused
        step then treats it exactly like a finished request's row."""
        self.install(slot, 0, 0, 0.0, -1, 0)

    def decode_block(self) -> np.ndarray:
        with no_host_sync(self.device):
            if self.paged:
                (block, self.pool.store, self.pool.page_table,
                 self.state) = self._decode(self.params, self.pool.store,
                                            self.pool.page_table, self.state)
            else:
                block, self.pool.caches, self.state = self._decode(
                    self.params, self.pool.caches, self.state)
        return block.cpu().numpy()               # the ONLY decode sync

    # -- paged admission surface (no-ops on the slab pool) ------------------

    @property
    def paged(self) -> bool:
        return isinstance(self.pool, PagedCachePool)

    def prefix_match(self, prompt):
        """(matched token count, shared page ids, conversation hit);
        (0, [], False) without a prefix-caching paged pool."""
        return (self.pool.prefix_match(prompt) if self.paged
                else (0, [], False))

    def alloc_slot_pages(self, slot: int, n_positions: int,
                         shared=()) -> None:
        """Reserve the slot's pages (raises PoolExhausted under pressure);
        a no-op on the slab pool, whose slot is its storage."""
        if self.paged:
            self.pool.alloc_pages(slot, n_positions, shared)

    def prefix_insert(self, prompt, slot: int) -> int:
        return self.pool.prefix_insert(prompt, slot) if self.paged else 0

    def conversation_insert(self, tokens, slot: int) -> int:
        """Publish a finished request's conversation into the radix tree
        from the slot's own pages; a no-op without a prefix index."""
        return self.pool.conversation_insert(tokens, slot) if self.paged \
            else 0

    def page_stats(self):
        """(pages_in_use, usable_pages), or None on the slab pool."""
        return self.pool.page_stats() if self.paged else None

    def prefill_suffix(self, batch: Dict[str, Any], slot: int,
                       index: int) -> torch.Tensor:
        """Prefix-hit admission: run only the (bucketed) suffix into the
        slot's pages, in place; returns the (1, S, vocab) suffix logits."""
        if not hasattr(self, "_suffix_prefill"):
            raise NotImplementedError(
                "backend was not built with a prefix-caching paged pool "
                "(EngineConfig.page_size + prefix_cache)")
        logits, self.pool.store = self._suffix_prefill(
            self.params, batch, self.pool.store, self.pool.page_table, slot,
            torch.tensor(index, dtype=torch.int32, device=self.device))
        return logits

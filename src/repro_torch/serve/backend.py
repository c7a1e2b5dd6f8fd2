"""Execution backend: where the serving steps run (the `LocalBackend` of
`repro.serve.backend`, slab form).

The backend owns the KV slab, the device-resident loop state and the
prefill / decode steps; the engine owns request lifecycle. On a CUDA
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
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.distributed import steps as ST
from repro_torch.models import transformer as T
from repro_torch.serve.cache_pool import CachePool


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
    """Single-device placement: slab pool + fused K-step decode loop."""

    name = "local"

    def build(self, model, cfg) -> None:
        self.model, self.cfg = model, cfg
        self.params = model.params
        self.device = torch.device(cfg.device)
        mcfg = model.cfg
        cdtype = getattr(torch, cfg.cache_dtype)
        self.pool = CachePool(mcfg, cfg.n_slots, cfg.max_len, cdtype,
                              self.device)
        kw = dict(cache_len=cfg.max_len, cache_dtype=cdtype, device=self.device)
        self._prefill_last = ST.make_prefill_step(mcfg, True, **kw)
        self._prefill_full = ST.make_prefill_step(mcfg, False, **kw)
        self._decode = ST.make_decode_step(mcfg, n_steps=cfg.decode_chunk)
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

    def decode_block(self) -> np.ndarray:
        with no_host_sync(self.device):
            block, self.pool.caches, self.state = self._decode(
                self.params, self.pool.caches, self.state)
        return block.cpu().numpy()               # the ONLY decode sync

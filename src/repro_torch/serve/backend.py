"""Execution backend: where the serving steps run (the `LocalBackend` of
`repro.serve.backend`, slab and native paged forms).

The backend owns the KV slab or page pool, the device-resident loop state
and the prefill / decode steps; the engine owns request lifecycle.

On a CUDA device `build` captures the decode dispatch (K micro-steps, or
one speculative propose-then-verify cycle) as ONE CUDA graph, the port's
counterpart of the JAX package's jitted dispatch, and every dispatch
replays it: one graph per built configuration (K, n_slots, slab or paged,
plain or speculative). The steps write their results into the state's,
the slab's and the page store's own tensors, so the graph's fixed
addresses stay valid; `install` and the pools' admission writes are the
only writers between replays. A capture that fails raises: the engine
never falls back to eager launches. The replay runs under
`torch.cuda.set_sync_debug_mode("error")`, so a host synchronisation
inside the dispatch raises instead of silently stalling it; the result is
copied out after the guard — the dispatch's one host sync. On the CPU the
eager step runs (the plain versions of the kernels). Prefill is not
graphed: its shape varies with the prompt. The sharded and multi-process
backends are not ported yet (ROADMAP.md queue 1, item 11).

Speculative decode (EngineConfig.speculate=K, serve.speculative) adds the
draft's slab (`draft_pool`: the target's slot assignment and per-slot
index clocks), the draft's batch-1 prefill at every admission and the
fused propose-then-verify step. Both caches are padded by K positions, so
the deepest speculative write stays in bounds before rollback. The
draft's prefill takes the admission's whole batch: a vision-stub
request's image rows enter the draft's cache and clock as the target's;
an encoder-decoder request's frames run through the draft's own encoder,
whose cross k/v land in the draft's slab (under a page pool too, where the
target's cross leaves stay resident in the store).

The host loop (EngineConfig.device_loop=False) builds no fused step: `decode_host` runs one (B, 1) forward of the slab and returns
its last column's logits to the host. On the card that forward is a CUDA
graph over static token and index buffers, which each step fills by an
upload, so the host loop against the device loop measures the per-step
round trip and the host's sampling, not eager launches.

Contract (what the engine calls):
  build(model, cfg)              allocate pools/state, make the steps,
                                 capture the dispatch's graph (CUDA)
  prefill(batch, exact)          -> (logits, batch-1 caches) on the device
                                 (speculating: also runs the draft's)
  write_slot(slot, caches)       copy a prefilled row into the slab(s)
  first_token(row, temperature)  sample the prefill token (one host sync)
  install(slot, ...)             write the slot's row of the loop state
  decode_block()                 ONE dispatch of K micro-steps; returns the
                                 (K, B) int32 block as numpy
  spec_decode_block()            ONE propose-then-verify cycle; returns
                                 (commit (B, K+1), n_commit, n_accept)
  decode_host(tokens, indices)   host loop: ONE (B, 1) forward; returns the
                                 (B, vocab) last-column logits as numpy
  release_slot(slot)             park a slot's loop-state row inert
and the paged admission surface (no-ops on the slab pool): `paged`,
`prefix_match`, `alloc_slot_pages`, `prefix_insert`,
`conversation_insert`, `page_stats`, `prefill_suffix`.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.distributed import steps as ST
from repro_torch.kernels import ops
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
    """Single-device placement: slab or page pool + the fused decode
    dispatch, replayed as a CUDA graph on the card."""

    name = "local"

    def build(self, model, cfg) -> None:
        self.model, self.cfg = model, cfg
        self.params = model.params
        self.device = torch.device(cfg.device)
        mcfg = model.cfg
        k = cfg.speculate
        # speculate=K pads the caches: the verify writes K+1 positions from
        # a per-slot clock that can sit at max_len - 1; rollback masks them
        cache_len = cfg.max_len + k
        cdtype = getattr(torch, cfg.cache_dtype)
        kw = dict(cache_len=cache_len, cache_dtype=cdtype, device=self.device)
        self._prefill_last = ST.make_prefill_step(mcfg, True, **kw)
        self._prefill_full = ST.make_prefill_step(mcfg, False, **kw)
        if cfg.page_size:
            self.pool = PagedCachePool(
                mcfg, cfg.n_slots, cache_len, cdtype, self.device,
                page_size=cfg.page_size, n_pages=cfg.n_pages,
                prefix_cache=cfg.prefix_cache)
            if self.pool.index is not None:
                self._suffix_prefill = ST.make_suffix_prefill_step(
                    mcfg, layout=self.pool.layout)
        else:
            self.pool = CachePool(mcfg, cfg.n_slots, cache_len, cdtype,
                                  self.device)
        self.state = ST.make_decode_state(cfg.n_slots, cfg.seed, self.device)
        self._first_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.draft_pool = None
        self._pending_draft = None
        self._graph = None
        if not cfg.device_loop:
            # the host loop: a (B, 1) forward over static input buffers
            self._host_tokens = torch.zeros((cfg.n_slots, 1), dtype=torch.int32,
                                            device=self.device)
            self._host_index = torch.zeros((cfg.n_slots,), dtype=torch.int32,
                                           device=self.device)
            self._host_step = ST.make_host_decode_step(mcfg)
            if self.device.type == "cuda":
                self._capture()
            return
        if k:
            dcfg = model.draft_cfg
            self.draft_params = model.draft_params
            ddtype = getattr(torch, cfg.draft_cache_dtype or cfg.cache_dtype)
            self.draft_pool = CachePool(dcfg, cfg.n_slots, cache_len, ddtype,
                                        self.device)
            self._draft_prefill = ST.make_prefill_step(
                dcfg, True, cache_len=cache_len, cache_dtype=ddtype,
                device=self.device)
            if cfg.page_size:
                self._step = ST.make_paged_speculative_decode_step(
                    mcfg, dcfg, n_draft=k, layout=self.pool.layout)
            else:
                self._step = ST.make_speculative_decode_step(mcfg, dcfg,
                                                             n_draft=k)
        elif cfg.page_size:
            self._step = ST.make_paged_decode_step(
                mcfg, n_steps=cfg.decode_chunk, layout=self.pool.layout)
        else:
            self._step = ST.make_decode_step(mcfg, n_steps=cfg.decode_chunk)
        if self.device.type == "cuda":
            self._capture()

    # -- the dispatch: the eager step, and its CUDA graph -------------------

    def _run(self) -> torch.Tensor:
        """One eager call of the built step on the live pools and state.
        Returns its int32 result on the device: the (K, B) token block, or
        the speculative (B, K+3) [commit | n_commit | n_accept], or the host
        loop's (B, vocab) last-column logits."""
        if not self.cfg.device_loop:
            return self._host_step(self.params, self.pool.caches,
                                   self._host_tokens, self._host_index)
        caches = self.pool.store if self.paged else self.pool.caches
        table = (self.pool.page_table,) if self.paged else ()
        if not self.cfg.speculate:
            return self._step(self.params, caches, *table, self.state)[0]
        commit, m, acc = self._step(self.params, self.draft_params, caches,
                                    *table, self.draft_pool.caches,
                                    self.state)[:3]
        return torch.cat([commit, m[:, None], acc[:, None]], dim=1)

    def _capture(self) -> None:
        """Capture `_run` as a CUDA graph, every slot parked (the
        `release_slot` row: remaining 0, inactive), so the warm-up and the
        capture write only rows that an admission overwrites: the slab's
        parked rows, the page pool's sink page. The eager warm-up (on a
        side stream: library handles, kernel attributes, the kernels'
        first loads) draws one dispatch's noise from the state's
        generator; the graph registers that generator, so every replay
        draws fresh noise from where the last one stopped, and sampled
        tokens stay a function of the seed."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.cfg.device_loop:
            graph.register_generator_state(self.state["generator"])
        # a graph that the collector frees inside the capture (an earlier
        # engine's, left in a reference cycle) invalidates the capture:
        # collect first and hold the collector off until it ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with ops.captured_launches() as per_replay:
                with torch.cuda.graph(graph):
                    out = self._run()
        finally:
            if collecting:
                gc.enable()
        self._graph, self._graph_out = graph, out
        self._graph_launches = per_replay

    def _dispatch(self, eager: bool) -> np.ndarray:
        with no_host_sync(self.device):
            if eager or self._graph is None:
                out = self._run()
            else:
                self._graph.replay()
                ops.count_replay(self._graph_launches)
                out = self._graph_out
        return out.cpu().numpy()                 # the ONLY decode sync

    def decode_block(self, eager: bool = False) -> np.ndarray:
        """ONE plain dispatch of K micro-steps: the graph's replay on the
        card, the eager step on the CPU or with eager=True (the graph's
        A/B partner on the same state). Returns the (K, B) int32 block."""
        if self.cfg.speculate or not self.cfg.device_loop:
            raise RuntimeError("backend built with EngineConfig.speculate or "
                               "device_loop=False: its dispatch is "
                               "spec_decode_block() or decode_host()")
        return self._dispatch(eager)

    def spec_decode_block(self, eager: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ONE propose-then-verify cycle (graph or eager as `decode_block`);
        its one host copy carries (commit (B, K+1), n_commit (B,),
        n_accept (B,)) as a single int32 block."""
        if not self.cfg.speculate:
            raise NotImplementedError(
                "backend was not built with EngineConfig.speculate")
        k = self.cfg.speculate
        out = self._dispatch(eager)
        return out[:, :k + 1], out[:, k + 1], out[:, k + 2]

    def decode_host(self, tokens: np.ndarray, indices: np.ndarray,
                    eager: bool = False) -> np.ndarray:
        """The host loop's step: upload the (B, 1) tokens and (B,) indices
        into the static buffers, run ONE (B, 1) forward (the graph's replay
        on the card, the eager forward on the CPU or with eager=True), and
        return its last column's (B, vocab) f32 logits as numpy."""
        if self.cfg.device_loop:
            raise RuntimeError("backend built with the device loop: its "
                               "dispatch is decode_block()")
        self._host_tokens.copy_(torch.from_numpy(tokens))
        self._host_index.copy_(torch.from_numpy(indices))
        return self._dispatch(eager)

    # -- admission ----------------------------------------------------------

    def prefill(self, batch: Dict[str, Any], exact: bool):
        fn = self._prefill_last if exact else self._prefill_full
        out = fn(self.params, batch)
        if self.draft_pool is not None:
            # the draft consumes the same prompt; its logits are unused (the
            # first token is sampled from the target's prefill)
            _, self._pending_draft = self._draft_prefill(self.draft_params,
                                                         batch)
        return out

    def write_slot(self, slot: int, caches) -> None:
        self.pool.write_slot(slot, caches)
        if self.draft_pool is not None:
            # the draft row shares the slot id and, from the next dispatch
            # on, the per-slot index clock with the target row
            self.draft_pool.write_slot(slot, self._pending_draft)
            self._pending_draft = None

    def first_token(self, row: torch.Tensor, temperature: float) -> int:
        temp = torch.full((1,), temperature, dtype=torch.float32,
                          device=self.device)
        return int(T.sample_tokens(row, self._first_gen, temp)[0])

    def install(self, slot: int, token: int, index: int, temperature: float,
                eos: int, remaining: int, spec_limit: int = 0) -> None:
        ST.install_slot(self.state, slot, token, index, temperature, eos,
                        remaining, spec_limit)

    def release_slot(self, slot: int) -> None:
        """Park a slot's loop-state row inert (remaining 0): the fused
        step then treats it exactly like a finished request's row."""
        self.install(slot, 0, 0, 0.0, -1, 0)

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

    def prefill_suffix(self, batch: Dict[str, Any], full_batch: Dict[str, Any],
                       slot: int, index: int) -> torch.Tensor:
        """Prefix-hit admission: run only the (bucketed) suffix into the
        slot's pages, in place; returns the (1, S, vocab) suffix logits. A
        speculating backend still prefills the FULL prompt (`full_batch`)
        into the draft's slab: the draft shares no pages."""
        if not hasattr(self, "_suffix_prefill"):
            raise NotImplementedError(
                "backend was not built with a prefix-caching paged pool "
                "(EngineConfig.page_size + prefix_cache)")
        logits, _ = self._suffix_prefill(
            self.params, batch, self.pool.store, self.pool.page_table, slot,
            torch.tensor(index, dtype=torch.int32, device=self.device))
        if self.draft_pool is not None:
            _, draft = self._draft_prefill(self.draft_params, full_batch)
            self.draft_pool.write_slot(slot, draft)
        return logits

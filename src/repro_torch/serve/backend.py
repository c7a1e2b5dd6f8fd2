"""Execution backend: where the serving steps run (`ExecutionBackend` and
the `LocalBackend` of `repro.serve.backend`, slab and paged forms).

The backend owns the KV slab or page pool, the device-resident loop state
and the prefill / decode steps; the engine owns request lifecycle. An
engine takes any `ExecutionBackend` (`InferenceEngine(..., backend=)`);
`LocalBackend` is the one-device placement. Under a page pool the decode
reads the store through the page table, or, with
`EngineConfig(paged_native=False)`, runs the legacy gather / slab step /
scatter form (steps.make_paged_decode_step), whose gather and scatter are
captured into the same graph.

On a CUDA device `build` captures the decode dispatch (K micro-steps, or
one speculative propose-then-verify cycle) as ONE CUDA graph, the port's
counterpart of the JAX package's jitted dispatch, and every dispatch
replays it: one graph per built configuration (K, n_slots, slab or paged,
plain or speculative) and per resident QoS tier (serve.qos: a tier swap
changes the parameters the graph reads, so `set_tier` selects that tier's
graph and never captures; the graphs share one memory pool, since one
replays at a time; under speculation the target's tier swaps and the
draft stays). The steps write their results into the state's,
the slab's and the page store's own tensors, so the graph's fixed
addresses stay valid; `install` and the pools' admission writes are the
only writers between replays. A capture that fails raises: the engine
never falls back to eager launches. The replay runs under
`torch.cuda.set_sync_debug_mode("error")`, so a host synchronisation
inside the dispatch raises instead of silently stalling it; the result is
copied out after the guard — the dispatch's one host sync. On the CPU the
eager step runs (the plain versions of the kernels). Prefill is not
graphed: its shape varies with the prompt. `ShardedBackend` and
`DistributedBackend` (below) place the same steps on a torch.distributed
device mesh, one process a rank.

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

The ineffectual-work ledger (EngineConfig.ledger, serve.ledger) is one
static (n_layers, width) f32 tensor allocated at build, which every probed
forward adds into in place (inside the graph on the card). The dispatch
packs the token block and the ledger's bits (an int32 view) into one
device buffer and copies it out once, so the ledger adds no host sync;
`last_ledger` holds the copied matrix. `maybe_rebase_ledger` zeroes the
same tensor in place (`zero_()`): a new tensor would leave every captured
graph writing to freed memory. `quality_shadow` runs an eager tier-0
prefill for the engine's per-tier quality probe.

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
  n_tiers, tier, set_tier(t)     the resident QoS tiers and the live one
  last_ledger, maybe_rebase_ledger(), quality_shadow(batch, exact)
                                 the ledger's drain and the quality probe
and the paged admission surface (no-ops on the slab pool): `paged`,
`prefix_match`, `alloc_slot_pages`, `prefix_insert`,
`conversation_insert`, `page_stats`, `gather_bytes_per_dispatch`,
`prefill_suffix`.
"""

from __future__ import annotations

import contextlib
import gc
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import steps as ST
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.serve.cache_pool import CachePool
from repro_torch.serve.paging import PagedCachePool


_warmup_streams: Dict[torch.device, Any] = {}


def warmup_stream(device: torch.device):
    """The one side stream of `device` that every capture's eager warm-up
    runs on. cuBLAS keeps a workspace (32 MiB on this card) for each
    stream it has run on until the process ends, so a fresh stream a
    build would hold that much more for every engine ever built, a
    replaced replica's included."""
    if device not in _warmup_streams:
        _warmup_streams[device] = torch.cuda.Stream(device)
    return _warmup_streams[device]


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


class ExecutionBackend:
    """Placement and step owner behind an InferenceEngine: `build` places
    the buffers and makes the steps; the contract above is what the engine
    calls."""

    name = "base"

    def build(self, model, cfg) -> None:
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"backend": self.name, "mesh_shape": [1, 1]}


class LocalBackend(ExecutionBackend):
    """Single-device placement: slab or page pool + the fused decode
    dispatch, replayed as a CUDA graph on the card."""

    name = "local"

    def build(self, model, cfg) -> None:
        self.model, self.cfg = model, cfg
        self.params = model.params
        # the QoS ladder: tier 0 is the model's own tree
        self._tier_params = [model.params, *model.tier_params]
        self.tier = 0
        self.device = torch.device(cfg.device)
        mcfg = model.cfg
        k = cfg.speculate
        ledger = cfg.ledger            # EngineConfig: device loop only
        self.ledger_buf = None if ledger is None else torch.zeros(
            (mcfg.n_layers, ledger.width), dtype=torch.float32,
            device=self.device)
        self.last_ledger = None
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
                prefix_cache=cfg.prefix_cache, **self._pool_kw())
            if self.pool.index is not None:
                self._suffix_prefill = ST.make_suffix_prefill_step(
                    mcfg, layout=self.pool.layout, ledger=ledger)
        else:
            self.pool = CachePool(mcfg, cfg.n_slots, cache_len, cdtype,
                                  self.device, **self._pool_kw())
        self.state = self._make_state()
        self._first_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.draft_pool = None
        self._pending_draft = None
        self._graph = None
        self._graphs = []
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
                                        self.device, **self._pool_kw())
            self._draft_prefill = ST.make_prefill_step(
                dcfg, True, cache_len=cache_len, cache_dtype=ddtype,
                device=self.device)
            if cfg.page_size:
                self._step = ST.make_paged_speculative_decode_step(
                    mcfg, dcfg, n_draft=k, layout=self.pool.layout,
                    native=cfg.paged_native, ledger=ledger)
            else:
                self._step = ST.make_speculative_decode_step(
                    mcfg, dcfg, n_draft=k, ledger=ledger)
        elif cfg.page_size:
            self._step = ST.make_paged_decode_step(
                mcfg, n_steps=cfg.decode_chunk, layout=self.pool.layout,
                native=cfg.paged_native, ledger=ledger)
        else:
            self._step = ST.make_decode_step(mcfg, n_steps=cfg.decode_chunk,
                                             ledger=ledger)
        if self.device.type == "cuda":
            self._capture()

    def _pool_kw(self) -> Dict[str, Any]:
        """Keyword arguments of the pools beyond their geometry (the
        sharded backend's mesh)."""
        return {}

    def _make_state(self):
        return ST.make_decode_state(self.cfg.n_slots, self.cfg.seed,
                                    self.device)

    # -- the dispatch: the eager step, and its CUDA graph -------------------

    def _run(self) -> torch.Tensor:
        """One eager call of the built step on the live pools and state.
        Returns its int32 result on the device: the (K, B) token block, or
        the speculative (B, K+3) [commit | n_commit | n_accept], or the host
        loop's (B, vocab) last-column logits. With the ledger, the result
        flattened and the ledger matrix's bits after it (`_split`)."""
        out = self._step_out()
        if self.ledger_buf is not None:
            # the ledger rides the dispatch's one host copy
            out = torch.cat([out.reshape(-1), self._ledger_out().view(
                torch.int32).reshape(-1)])
        return out

    def _ledger_out(self) -> torch.Tensor:
        """The ledger matrix a dispatch copies out."""
        return self.ledger_buf

    def _step_out(self) -> torch.Tensor:
        """The built step's result, without the ledger (see `_run`)."""
        if not self.cfg.device_loop:
            return self._host_step(self.params, self.pool.caches,
                                   self._host_tokens, self._host_index)
        caches = self.pool.store if self.paged else self.pool.caches
        table = (self.pool.page_table,) if self.paged else ()
        led = () if self.ledger_buf is None else (self.ledger_buf,)
        if not self.cfg.speculate:
            out = self._step(self.params, caches, *table, self.state,
                             *led)[0]
        else:
            commit, m, acc = self._step(self.params, self.draft_params,
                                        caches, *table,
                                        self.draft_pool.caches, self.state,
                                        *led)[:3]
            out = torch.cat([commit, m[:, None], acc[:, None]], dim=1)
        return out

    def _split(self, out: np.ndarray, shape) -> np.ndarray:
        """The dispatch's result of `shape` from its host copy; with the
        ledger, the matrix after it goes to `last_ledger`."""
        if self.ledger_buf is None:
            return out
        n = int(np.prod(shape))
        self.last_ledger = out[n:].view(np.float32).reshape(
            self.ledger_buf.shape)
        return out[:n].reshape(shape)

    def _capture(self) -> None:
        """Capture `_run` as one CUDA graph per resident tier, every slot
        parked (the `release_slot` row: remaining 0, inactive), so the
        warm-ups and the captures write only rows that an admission
        overwrites: the slab's parked rows, the page pool's sink page.
        Each tier's eager warm-up (on a side stream: library handles,
        kernel attributes, the kernels' first loads) draws one dispatch's
        noise from the state's generator; each graph registers that
        generator, so every replay draws fresh noise from where the last
        one stopped, and sampled tokens stay a function of the seed. The
        graphs share one memory pool: one replays at a time, and each
        result is copied out right after its replay. The warm-ups' ledger
        rows are zeroed after the captures."""
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        self._graphs = []
        for params in self._tier_params:
            self.params = params
            side = warmup_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if self.cfg.device_loop:
                graph.register_generator_state(self.state["generator"])
            # a graph that the collector frees inside the capture (an
            # earlier engine's, left in a reference cycle) invalidates the
            # capture: collect first and hold the collector off until it
            # ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with ops.captured_launches() as per_replay:
                    with torch.cuda.graph(graph, pool=pool):
                        out = self._run()
            finally:
                if collecting:
                    gc.enable()
            self._graphs.append((graph, out, per_replay))
        if self.ledger_buf is not None:
            self.ledger_buf.zero_()
        self.set_tier(0)

    def _device_out(self, eager: bool) -> torch.Tensor:
        """The dispatch's result on the device: the graph's replay, or the
        eager step."""
        with no_host_sync(self.device):
            if eager or self._graph is None:
                return self._run()
            self._graph.replay()
            ops.count_replay(self._graph_launches)
            return self._graph_out

    def _dispatch(self, eager: bool) -> np.ndarray:
        return self._device_out(eager).cpu().numpy()   # the ONLY decode sync

    # -- QoS tiers (serve.qos) ----------------------------------------------

    @property
    def n_tiers(self) -> int:
        """Resident quality tiers this backend can swap between."""
        return len(self._tier_params)

    def set_tier(self, tier: int) -> None:
        """Swap the live decode onto packed tier `tier` (0 = full quality):
        the prefill and the step read that tier's parameters, and on the
        card the dispatch replays that tier's graph. The pools, the page
        table and the loop state stay put, so every resident request
        continues from its exact position."""
        if not 0 <= tier < self.n_tiers:
            raise ValueError(f"tier {tier} out of range "
                             f"(n_tiers={self.n_tiers})")
        self.params = self._tier_params[tier]
        self.tier = tier
        if self._graphs:
            self._graph, self._graph_out, self._graph_launches = \
                self._graphs[tier]

    # -- ineffectual-work ledger (serve.ledger) -----------------------------

    def maybe_rebase_ledger(self) -> bool:
        """Zero the device counter matrix, in place, once any cell reaches
        2**23 (counts are exact in f32 up to 2**24). Called by the engine
        right after draining `last_ledger`; True tells the LedgerSink to
        reset its snapshot to match."""
        if (self.last_ledger is None
                or float(self.last_ledger.max()) < float(2 ** 23)):
            return False
        self.ledger_buf.zero_()
        self.last_ledger = None
        return True

    def quality_shadow(self, batch: Dict[str, Any], exact: bool) -> np.ndarray:
        """The engine's per-tier quality probe: one admitted prompt's
        prefill through TIER-0 parameters (eager), its logits on the host:
        a metered host pull at admission, never in the decode path."""
        fn = self._prefill_last if exact else self._prefill_full
        logits, _ = fn(self._tier_params[0], batch)
        return logits.float().cpu().numpy()

    def decode_block(self, eager: bool = False) -> np.ndarray:
        """ONE plain dispatch of K micro-steps: the graph's replay on the
        card, the eager step on the CPU or with eager=True (the graph's
        A/B partner on the same state). Returns the (K, B) int32 block."""
        if self.cfg.speculate or not self.cfg.device_loop:
            raise RuntimeError("backend built with EngineConfig.speculate or "
                               "device_loop=False: its dispatch is "
                               "spec_decode_block() or decode_host()")
        return self._split(self._dispatch(eager),
                           (self.cfg.decode_chunk, self.cfg.n_slots))

    def spec_decode_block(self, eager: bool = False
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ONE propose-then-verify cycle (graph or eager as `decode_block`);
        its one host copy carries (commit (B, K+1), n_commit (B,),
        n_accept (B,)) as a single int32 block."""
        if not self.cfg.speculate:
            raise NotImplementedError(
                "backend was not built with EngineConfig.speculate")
        k = self.cfg.speculate
        out = self._split(self._dispatch(eager), (self.cfg.n_slots, k + 3))
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

    def gather_bytes_per_dispatch(self) -> int:
        """Bytes a gather/scatter paged decode would move per dispatch: what
        the native form avoids (0 on the slab pool, and on the legacy form,
        which moves them)."""
        if self.paged and self.cfg.paged_native:
            return self.pool.gather_bytes_per_dispatch()
        return 0

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
        # the ledger stays on the device: the next dispatch's copy drains it
        led = () if self.ledger_buf is None else (self.ledger_buf,)
        logits = self._suffix_prefill(
            self.params, batch, self.pool.store, self.pool.page_table, slot,
            torch.tensor(index, dtype=torch.int32, device=self.device),
            *led)[0]
        if self.draft_pool is not None:
            _, draft = self._draft_prefill(self.draft_params, full_batch)
            self.draft_pool.write_slot(slot, draft)
        return logits


class ShardedBackend(LocalBackend):
    """Mesh placement: every rank of the mesh runs the same engine and
    the same dispatch on its shard (multi-controller SPMD, one process a
    device).

    mesh: a `torch.distributed.device_mesh.DeviceMesh` with ('data',
    'model') axes (a replica submesh from `launch.mesh.replica_meshes`, or
    the whole group's); mesh_shape: build a (data, model) mesh over the
    group's ranks instead (default: (world size, 1)). Greedy decode, and
    sampled decode, are token-identical to LocalBackend.

    What each rank keeps (the port's placement, against the JAX package's
    specs in ROADMAP.md):
      * parameters, packed buffers and the draft: replicated; each rank
        runs the hand-written kernels on its own rows;
      * the slab (and a speculating engine's draft slab): its block of
        slot rows over 'data' and its share of the kv heads (a Mamba
        layer's channels) over 'model', as `sharding.cache_pspecs(slab=
        True)` places them; the per-slot loop state: its block of rows
        (`steps.decode_state_pspecs`); a slot count that 'data' does not
        divide replicates the rows;
      * a page store: its kv heads over 'model'; pages, page table and
        loop state replicated over 'data', whose ranks all decode every
        slot (serve.paging.PagedCachePool);
      * the ledger's counter matrix: each rank counts its rows, and a
        dispatch copies out the sum over 'data'.
    A dispatch all-gathers the token block over 'data', so every rank's
    host sees every slot and its bookkeeping stays whole. Decode attention
    and the Mamba recurrence run on the rank's heads / channels and are
    all-gathered over 'model' before the packed output projection
    (`distributed.sharding.use_mesh`, installed around every dispatch).
    The prefill runs whole on every rank (a batch of one), and each rank
    keeps its part of the prefilled row.

    A rank outside the mesh (another replica's, under a router) holds
    nothing and runs no step: it mirrors the replica's host bookkeeping,
    and each dispatch's result reaches it by a broadcast from the mesh's
    first rank, so every rank's router sees every replica. On the card the
    dispatch is captured as a CUDA graph as LocalBackend's; a one-rank
    axis issues no collective.
    """

    name = "sharded"

    def __init__(self, mesh=None, *,
                 mesh_shape: Optional[Tuple[int, int]] = None):
        if mesh is not None and mesh_shape is not None:
            raise ValueError("pass mesh OR mesh_shape, not both")
        self._mesh = mesh
        self._mesh_shape = mesh_shape

    def build(self, model, cfg) -> None:
        import torch.distributed as dist

        from repro_torch.launch import mesh as M

        if not cfg.device_loop:
            raise ValueError("ShardedBackend requires device_loop=True: the "
                             "host loop pulls full-vocab logits every step, "
                             "which is exactly the cross-boundary traffic a "
                             "mesh placement must avoid")
        M.ensure_world(cfg.device)
        if self._mesh is None:
            shape = self._mesh_shape or (dist.get_world_size(), 1)
            self._mesh = M.make_local_mesh(*shape, device=cfg.device)
        mesh = self.mesh = self._mesh
        self._member = SH.in_mesh(mesh)
        ranks = mesh.mesh.reshape(-1).tolist()
        # a replica submesh under a router: results reach the other ranks
        # that run the same host bookkeeping (the peers)
        self._src = ranks[0] if len(ranks) < self._n_peers() else None
        self._data = SH.axis_group(mesh, "data") if self._member else None
        super().build(model, cfg)

    def _n_peers(self) -> int:
        """How many ranks run this engine's host bookkeeping: every rank
        of the group (the SPMD launch)."""
        import torch.distributed as dist
        return dist.get_world_size()

    def _pool_kw(self) -> Dict[str, Any]:
        return {"mesh": self.mesh}

    def _ctx(self):
        return SH.use_mesh(self.mesh)

    def _make_state(self):
        """This rank's rows of the loop state (`rows` the first slot and
        the slot count, for the sampling noise), and the dispatch's
        geometry."""
        cfg = self.cfg
        lo, n = (0, cfg.n_slots) if self.paged else self.pool.rows
        if not self._member:
            lo, n = 0, 0
        self._rows = (lo, n)
        # 'data' splits the slots of the slab only where it divides them
        self._split_slots = self._data is not None and 0 < n < cfg.n_slots
        k = cfg.speculate
        self._out_shape = (cfg.n_slots, k + 3) if k else \
            (cfg.decode_chunk, cfg.n_slots)
        self._out_numel = int(np.prod(self._out_shape)) + (
            0 if self.ledger_buf is None else self.ledger_buf.numel())
        state = ST.make_decode_state(n, cfg.seed, self.device)
        state["rows"] = (lo, cfg.n_slots)
        return state

    def _capture(self) -> None:
        if self._member:
            super()._capture()

    def _step_out(self) -> torch.Tensor:
        with self._ctx():
            out = super()._step_out()
        if self._split_slots:
            # every rank's host sees every slot
            out = SH.all_gather_axis(out, 0 if self.cfg.speculate else 1,
                                     self._data)
        return out

    def _ledger_out(self) -> torch.Tensor:
        if not self._split_slots:
            return self.ledger_buf
        import torch.distributed as dist
        total = self.ledger_buf.clone()
        dist.all_reduce(total, group=self._data)
        return total

    def _device_out(self, eager: bool) -> torch.Tensor:
        if self._src is None:
            return super()._device_out(eager)
        import torch.distributed as dist
        out = super()._device_out(eager).reshape(-1).contiguous() \
            if self._member else torch.empty(
                self._out_numel, dtype=torch.int32, device=self.device)
        dist.broadcast(out, src=self._src)
        return out if self.ledger_buf is not None else \
            out.reshape(self._out_shape)

    def install(self, slot: int, token: int, index: int, temperature: float,
                eos: int, remaining: int, spec_limit: int = 0) -> None:
        lo, n = self._rows
        if lo <= slot < lo + n:
            ST.install_slot(self.state, slot - lo, token, index, temperature,
                            eos, remaining, spec_limit)

    def prefill_suffix(self, batch: Dict[str, Any], full_batch: Dict[str, Any],
                       slot: int, index: int) -> torch.Tensor:
        if self._member:
            with self._ctx():
                logits = super().prefill_suffix(batch, full_batch, slot,
                                                index)
        else:
            logits = torch.empty(
                (1, batch["tokens"].shape[1], self.model.cfg.vocab),
                dtype=torch.float32, device=self.device)
        if self._src is not None:
            import torch.distributed as dist
            logits = logits.float().contiguous()
            dist.broadcast(logits, src=self._src)
        return logits

    def describe(self) -> Dict[str, Any]:
        axes = SH.mesh_axes(self.mesh)
        return {"backend": self.name,
                "mesh_shape": list(axes.values()),
                "mesh_axes": list(axes),
                "n_devices": int(np.prod(list(axes.values())))}


def ensure_distributed(coordinator_address: str, num_processes: int,
                       process_id: int, *, device="cuda") -> None:
    """Idempotent `torch.distributed.init_process_group` of this process
    as rank `process_id` of `num_processes`, rendezvousing at
    `coordinator_address` ('HOST:PORT'): NCCL on the card, gloo with
    device='cpu'. On the card the process takes device `LOCAL_RANK` (as
    torchrun sets it), else process_id modulo the visible cards. A second
    call with the same identity is a no-op; another identity, or a group
    of the other backend, raises ValueError."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    backend = M.dist_backend(device)
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if have != (num_processes, process_id, backend):
            raise ValueError(f"process group already initialized as rank "
                             f"{have[1]} of {have[0]} on {have[2]}; asked "
                             f"for rank {process_id} of {num_processes} on "
                             f"{backend}")
        return
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


class DistributedBackend(ShardedBackend):
    """One fleet process's placement: `ensure_distributed` (when a
    coordinator address is given), then ShardedBackend on replica
    `replica` of `launch.mesh.process_meshes`, the meshes over this
    process's ranks. In a group that is one block of ranks (torchrun)
    that is ShardedBackend on `replica_meshes` exactly, token for token."""

    name = "distributed"

    def __init__(self, *, mesh_shape: Tuple[int, int], n_replicas: int = 1,
                 replica: int = 0, coordinator_address: Optional[str] = None,
                 num_processes: int = 1, process_id: int = 0,
                 device="cuda"):
        if coordinator_address:
            ensure_distributed(coordinator_address, num_processes,
                               process_id, device=device)
        if not 0 <= replica < n_replicas:
            raise ValueError(f"replica {replica} out of range "
                             f"(n_replicas={n_replicas})")
        self._fleet = dict(mesh_shape=tuple(mesh_shape),
                           n_replicas=n_replicas, replica=replica)
        super().__init__(mesh=None)

    def build(self, model, cfg) -> None:
        import torch.distributed as dist

        from repro_torch.launch import mesh as M
        f = self._fleet
        d, m = f["mesh_shape"]
        M.ensure_world(cfg.device)
        if f["n_replicas"] > 1 and d * m < dist.get_world_size():
            raise NotImplementedError(
                "several replicas in a process block of a larger group "
                "(a fleet worker owning several devices): ROADMAP.md queue "
                "1, item 14 (multi-device fleet workers)")
        if self._mesh is None:
            self._mesh = M.process_meshes(
                d, m, f["n_replicas"], device=cfg.device)[f["replica"]]
        super().build(model, cfg)

    def _n_peers(self) -> int:
        """The ranks of this process's block (launch.mesh.process_meshes):
        one fleet worker's replicas run on its own ranks alone."""
        d, m = self._fleet["mesh_shape"]
        return d * m

    def describe(self) -> Dict[str, Any]:
        import torch.distributed as dist
        d = super().describe()
        d.update({"process_index": int(dist.get_rank()),
                  "num_processes": int(dist.get_world_size()),
                  "replica": int(self._fleet["replica"])})
        return d

"""Block-paged KV pool with radix-tree prefix reuse (port of
`repro.serve.paging`, one device).

The slab (serve.cache_pool) reserves one `max_len` stride per slot. This
pool carves the same memory into fixed-size PAGES:

  * every cache leaf with the positional `cache_len` axis is stored
    page-major: the slab's (n_slots, KV, cache_len, dh) becomes
    (n_pages, KV, page_size, dh) — the page axis sits where the slot axis
    sat (axis 0 of every per-layer leaf);
  * each slot owns an int32 row of a (n_slots, pages_per_slot) PAGE TABLE
    mapping position p to page table[slot, p // P]; the table lives on the
    device and is written only at admission and release;
  * page alloc/free is free-list bookkeeping with REFCOUNTS: a page shared
    by several slots and/or retained by the prefix index frees only when
    its last reference drops;
  * native decode reads and writes the store through the table
    (models.attention's paged branch, kernels.ops.paged_attention), so no
    slab view exists on its path. The legacy form
    (`EngineConfig(paged_native=False)`, the A/B baseline) gathers every
    slot's pages into the slab layout (`PageLayout.gather`), runs the
    unchanged slab step and scatters the view back (`PageLayout.scatter`);
    each call appends one event to `GATHER_EVENTS`.

Leaves that are not positional stay RESIDENT in the slot-major slab
layout inside the same store: a circular sliding-window leaf whose W is
shorter than cache_len (by shape) and, by name, since their shapes do not
say what they are, a Mamba layer's recurrent `conv` tail and `ssm` state
and an encoder-decoder layer's cross-attention k/v (`cross_k`, `cross_v`:
written once at admission; at max_len == enc_positions they have a paged
leaf's shape). The jamba hybrid pages its attention layer's k/v and keeps
its Mamba layers' state resident.

Page 0 is the reserved WRITE SINK: a freed slot's table row resets to it,
so an idle slot's garbage decode writes land in a page nobody reads. Rows
past a slot's allocated length point at it too; the per-slot validity
clocks keep those positions inert.

Prefix reuse: `prefix_match` returns the longest PAGE-ALIGNED cached
prefix (capped at prompt_len - 1, so a suffix token remains to produce the
first-sample logits); admission bumps the shared pages' refcounts
(`alloc_pages`), prefills only the suffix, and publishes the prompt's full
pages (`prefix_insert`). A finished request publishes its whole
conversation (`conversation_insert`) so a follow-up turn skips prefill
over everything said so far. Only pages with complete, final KV are ever
published, so sharing needs no copy-on-write. Under page pressure
allocation first evicts LRU tree pages nobody else references, then raises
`PoolExhausted` (the engine requeues the admission).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import convert as CV
from repro_torch.distributed import sharding as SH
from repro_torch.instrument import REGISTRY
from repro_torch.kernels.ref import last_write, paged_view
from repro_torch.models import transformer as T
from repro_torch.serve.cache_pool import PoolExhausted
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.trace import NULL_TRACER

Store = List[Dict[str, torch.Tensor]]

# ("gather" | "scatter", n_paged_leaves, slab_view_bytes), appended by every
# call of the legacy decode's full gather or scatter (the registry's
# "gather" stream): one per eager dispatch or graph capture, none per
# replay. Native paged decode appends none; the batch-1 admission copies
# (gather_one / scatter_one) do not count.
GATHER_EVENTS = REGISTRY.event_list("gather")


RESIDENT_LEAVES = frozenset({"conv", "ssm", "cross_k", "cross_v"})


def _slab_slices(sl, paged: bool):
    """The part of a batch-1 slab row that a store leaf's local slices
    `sl` keep: every axis but the slot / page axis, and for a paged leaf
    not its page-interior and feature axes (which the slab lays out as
    positions and which are never sharded)."""
    return (slice(None),) + (sl[1:-2] + (slice(None),) * 2 if paged
                             else sl[1:])


def prefix_supported(cfg: T.ModelConfig) -> bool:
    """Archs whose whole per-request cache state is positional and paged —
    the precondition for prefix sharing to reproduce a prefill exactly. A
    circular window overwrites position identity; a recurrent state (pure
    Mamba or the hybrid) sums the whole prompt and no page of it can be
    shared; a vision prompt carries image rows, and an encoder-decoder's
    its audio frames, that the token-keyed index cannot see."""
    return not (cfg.window or cfg.is_ssm or cfg.attn_period or cfg.enc_dec
                or cfg.n_img_tokens or cfg.frontend)


class PageLayout:
    """Leaf classification plus the gather/scatter between the page store
    and the slab layout: batch-1 for suffix prefill and slot install, all
    slots for the legacy paged decode.

    The store is the per-layer leaf list of `T.make_caches(cfg, n_slots,
    cache_len)` with every PAGED leaf re-laid out page-major. `as_tree`
    hands the store to the forward as its cache list unchanged."""

    def __init__(self, cfg: T.ModelConfig, n_slots: int, cache_len: int,
                 page_size: int, dtype=torch.float32, device="cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg, self.n_slots = cfg, n_slots
        self.cache_len, self.page_size = cache_len, page_size
        self.pp = -(-cache_len // page_size)          # pages per slot
        self.dtype, self.device = dtype, torch.device(device)
        template = T.make_caches(cfg, n_slots, cache_len, dtype, "meta")
        self.slab_shapes = [{n: tuple(t.shape) for n, t in layer.items()}
                            for layer in template]
        self.paged = [{n: n not in RESIDENT_LEAVES and len(s) >= 3
                       and s[-2] == cache_len
                       for n, s in layer.items()}
                      for layer in self.slab_shapes]
        self.has_paged = any(any(layer.values()) for layer in self.paged)
        # the reference's cache tree stacks a scan slot's layers into one
        # leaf: its leaves are the prelude layers' and each slot's first
        # layer's (describe() and the events count them so)
        kinds = [v for i in CV.reference_layers(cfg)
                 for v in self.paged[i].values()]
        self.n_paged_leaves = sum(kinds)
        self.n_resident_leaves = len(kinds) - self.n_paged_leaves

    def slab_view_bytes(self) -> int:
        """Bytes of the slab view of the paged leaves: what a gather
        materialises, per direction."""
        item = torch.empty((), dtype=self.dtype).element_size()
        return sum(int(np.prod(s)) * item
                   for shapes, paged in zip(self.slab_shapes, self.paged)
                   for n, s in shapes.items() if paged[n])

    def store_shapes(self, n_pages: int) -> List[Dict[str, Tuple[int, ...]]]:
        out = []
        for shapes, paged in zip(self.slab_shapes, self.paged):
            out.append({n: (n_pages, *s[1:-2], self.page_size, s[-1])
                        if paged[n] else s for n, s in shapes.items()})
        return out

    def make_store(self, n_pages: int) -> Store:
        return [{n: torch.zeros(s, dtype=self.dtype, device=self.device)
                 for n, s in layer.items()}
                for layer in self.store_shapes(n_pages)]

    def as_tree(self, store: Store) -> Store:
        """The cache list the native paged forward takes: the store itself
        (the page axis sits where the slot axis sat)."""
        return store

    def _gather_leaf(self, leaf, table):
        return paged_view(leaf, table)[..., :self.cache_len, :]

    def _scatter_leaf(self, store_leaf, table, slab_leaf) -> None:
        """Write slab rows (B, ..., cache_len, d) into the pages of the
        (B, pp) `table`. A page named more than once over the flattened
        table (the sink page of parked slots and of rows past a slot's
        pages, a shared prefix page) takes the value of its last write in
        table order (`last_write`), on the card as on the CPU and in the
        reference's scatter."""
        ids = table.long().reshape(-1)
        pad = self.pp * self.page_size - self.cache_len
        x = slab_leaf
        if pad:   # the final partial page is private by construction
            x = torch.cat([x, x.new_zeros((*x.shape[:-2], pad, x.shape[-1]))],
                          dim=-2)
        x = x.unflatten(-2, (self.pp, self.page_size)).movedim(-3, 1)
        store_leaf[ids] = x.flatten(0, 1)[last_write(ids)].to(
            store_leaf.dtype)

    def gather(self, store: Store, page_table: torch.Tensor) -> Store:
        """Page store + (n_slots, pp) table -> the full slab cache list of
        the legacy paged decode: each paged leaf a new (n_slots, ...,
        cache_len, d) tensor, each resident leaf the store's own tensor
        (the slab step updates it in place). Appends a GATHER_EVENTS
        entry."""
        GATHER_EVENTS.append(("gather", self.n_paged_leaves,
                              self.slab_view_bytes()))
        return [{n: self._gather_leaf(t, page_table) if paged[n] else t
                 for n, t in layer.items()}
                for layer, paged in zip(store, self.paged)]

    def scatter(self, store: Store, page_table: torch.Tensor,
                caches: Store) -> None:
        """Write the slab cache list back into the store, in place: paged
        leaves into their pages (shared pages receive back the values they
        supplied), resident leaves where they are not the store's own
        tensor. Static shapes and no host sync, so it captures into the
        dispatch's CUDA graph. Appends a GATHER_EVENTS entry."""
        GATHER_EVENTS.append(("scatter", self.n_paged_leaves,
                              self.slab_view_bytes()))
        for layer, new, paged in zip(store, caches, self.paged):
            for n, t in layer.items():
                if paged[n]:
                    self._scatter_leaf(t, page_table, new[n])
                elif new[n] is not t:
                    t.copy_(new[n])

    def gather_one(self, store: Store, table_row: torch.Tensor,
                   slot: int) -> Store:
        """Batch-1 slab-layout copy of one slot (suffix prefill)."""
        return [{n: self._gather_leaf(t, table_row[None]) if paged[n]
                 else t[slot:slot + 1].clone()
                 for n, t in layer.items()}
                for layer, paged in zip(store, self.paged)]

    def scatter_one(self, store: Store, table_row: torch.Tensor, slot: int,
                    caches: Store) -> None:
        """Write a batch-1 slab-layout cache into the slot's pages (and its
        resident rows), in place. Shared prefix pages receive back the
        values they supplied."""
        for layer, one, paged in zip(store, caches, self.paged):
            for n, t in layer.items():
                if paged[n]:
                    self._scatter_leaf(t, table_row[None], one[n])
                else:
                    t[slot].copy_(one[n][0])


class PagedCachePool:
    """Fixed-page KV pool: refcounted pages + per-slot page tables.

    Same slot surface as `CachePool` (alloc / free / n_free / n_active /
    write_slot) plus the paging and prefix-reuse surface the engine's
    admission drives: `prefix_match` -> `alloc_pages` -> (suffix) prefill
    -> `prefix_insert`, and `conversation_insert` at finish."""

    # the engine re-points this at its Tracer when tracing is on
    tracer = NULL_TRACER

    def __init__(self, cfg: T.ModelConfig, n_slots: int, max_len: int,
                 dtype=torch.float32, device="cuda", *, page_size: int,
                 n_pages: Optional[int] = None, prefix_cache: bool = True,
                 mesh=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg, self.n_slots = cfg, n_slots
        self.max_len, self.dtype = max_len, dtype
        self.layout = PageLayout(cfg, n_slots, max_len, page_size, dtype,
                                 device)
        self.page_size, self.pp = page_size, self.layout.pp
        # +1: page 0 is the reserved write sink, never allocated
        self.n_pages = n_pages if n_pages is not None \
            else n_slots * self.pp + 1
        if self.layout.has_paged and self.n_pages < self.pp + 1:
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one full slot "
                f"({self.pp} pages) plus the reserved sink page")
        self.mesh, self.shardings, self._slices = mesh, None, None
        if mesh is None:
            self.store = self.layout.make_store(self.n_pages)
        else:
            self._shard_store(mesh, device)
        self.page_table = torch.zeros((n_slots, self.pp), dtype=torch.int32,
                                      device=device)
        self._table = np.zeros((n_slots, self.pp), np.int32)
        self.refs = np.zeros(self.n_pages, np.int32)
        self.refs[0] = 1                       # the sink is never freeable
        self._free_pages: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self.index = PrefixIndex(page_size) \
            if (prefix_cache and self.layout.has_paged
                and prefix_supported(cfg)) else None

    def _shard_store(self, mesh, device) -> None:
        """This rank's part of the store on `mesh`: `page_pspecs`' kv-head
        (and Mamba-channel) entries over 'model'; the page axis, and a
        resident leaf's slot axis, replicated over 'data', so every rank
        reads any page, a shared prefix page included, and the allocator
        and the prefix index stay one (the JAX package shards the page
        axis over 'data' and lets GSPMD gather)."""
        template = T.make_caches(self.cfg, self.n_slots, self.max_len,
                                 self.dtype, "meta")
        specs = SH.page_pspecs(template, self.layout, mesh, self.n_pages)
        self.shardings = [{n: SH.NamedSharding(mesh, SH.P(None, *s[1:]))
                           for n, s in layer.items()} for layer in specs]
        shapes = self.layout.store_shapes(self.n_pages)
        self._slices = [{n: sh.local_slices(shapes[i][n])
                         for n, sh in layer.items()}
                        for i, layer in enumerate(self.shardings)]
        self.store = [{n: torch.zeros(tuple(x.stop - x.start for x in sl),
                                      dtype=self.dtype, device=device)
                       for n, sl in layer.items()} for layer in self._slices]
        self._bytes = sum(int(np.prod(s)) for layer in shapes
                          for s in layer.values()) \
            * torch.empty((), dtype=self.dtype).element_size()

    # -------------------------------------------------------------- slots

    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free_slots)

    def alloc(self) -> int:
        if not self._free_slots:
            raise PoolExhausted(
                f"all {self.n_slots} cache slots in use; admission must wait")
        return self._free_slots.pop()

    def _set_row(self, slot: int, row: np.ndarray) -> None:
        self._table[slot] = row
        self.page_table[slot] = torch.from_numpy(row).to(
            self.page_table.device)

    def free(self, slot: int) -> None:
        """Release a slot and its page references; pages the prefix index
        retains survive. The slot's table row resets to the sink page."""
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free_slots:
            raise ValueError(f"double-free of slot {slot}")
        self.tracer.page_free(slot, len(self._slot_pages[slot]))
        for p in self._slot_pages[slot]:
            self._release(p)
        self._slot_pages[slot] = []
        self._set_row(slot, np.zeros((self.pp,), np.int32))
        self._free_slots.append(slot)

    # -------------------------------------------------------------- pages

    def _retain(self, page: int) -> None:
        self.refs[page] += 1

    def _release(self, page: int) -> None:
        self.refs[page] -= 1
        assert self.refs[page] >= 0, f"refcount underflow on page {page}"
        if self.refs[page] == 0:
            self._free_pages.append(page)

    def pages_needed(self, n_positions: int) -> int:
        if not self.layout.has_paged:
            return 0
        return -(-min(n_positions, self.max_len) // self.page_size)

    @property
    def n_usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - 1 - len(self._free_pages)

    def page_stats(self) -> Tuple[int, int]:
        return self.pages_in_use, self.n_usable_pages

    def alloc_pages(self, slot: int, n_positions: int,
                    shared: Sequence[int] = ()) -> None:
        """Install a slot's page-table row: the `shared` prefix pages (from
        `prefix_match` in the same admission; refcount bump) followed by
        fresh private pages covering `n_positions`. LRU tree-only pages are
        evicted first under pressure; a request the pool still cannot hold
        raises `PoolExhausted` with every refcount restored."""
        need = self.pages_needed(n_positions)
        shared = list(shared)
        assert len(shared) <= need, (len(shared), need)
        for p in shared:
            self._retain(p)     # before eviction: a matched page is pinned
        n_new = need - len(shared)
        if n_new > len(self._free_pages) and self.index is not None:
            free_before = len(self._free_pages)
            self.index.evict(n_new - len(self._free_pages),
                             can_free=lambda p: self.refs[p] == 1,
                             release=self._release)
            freed = len(self._free_pages) - free_before
            if freed:
                self.tracer.page_evict(freed)
        if n_new > len(self._free_pages):
            for p in shared:
                self._release(p)
            raise PoolExhausted(
                f"{n_new} pages needed, {len(self._free_pages)} free "
                f"(of {self.n_usable_pages}); admission must wait")
        fresh = [self._free_pages.pop() for _ in range(n_new)]
        for p in fresh:
            self.refs[p] = 1
        self.tracer.page_alloc(slot, len(shared), n_new)
        pages = shared + fresh
        self._slot_pages[slot] = pages
        row = np.zeros((self.pp,), np.int32)
        row[:len(pages)] = pages
        self._set_row(slot, row)

    # ------------------------------------------------------------- prefix

    def prefix_match(self, tokens) -> Tuple[int, List[int], bool]:
        """(matched token count, shared page ids, conversation hit) for the
        longest cached page-aligned prefix, capped at len(tokens) - 1. The
        third element is True when the match reached pages published at a
        request finish (whole-conversation reuse)."""
        if self.index is None:
            return 0, [], False
        pages, conversation = self.index.match(tokens)
        cap = max(0, (len(tokens) - 1) // self.page_size)
        pages = pages[:cap]
        return len(pages) * self.page_size, pages, conversation and \
            bool(pages)

    def prefix_insert(self, tokens, slot: int) -> int:
        """Publish the slot's FULL prompt pages (never the partial tail: it
        receives this request's generated tokens) into the tree."""
        if self.index is None:
            return 0
        n_full = len(tokens) // self.page_size
        return self.index.insert(tokens, self._slot_pages[slot][:n_full],
                                 retain=self._retain)

    def conversation_insert(self, tokens, slot: int) -> int:
        """Publish a FINISHED request's conversation (prompt + generated).
        Decode never writes KV for the final emitted token, so valid KV
        ends at len(tokens) - 2 and (len(tokens) - 1) // page_size pages
        publish; every later write lands strictly past them."""
        if self.index is None:
            return 0
        n_full = max(0, (len(tokens) - 1) // self.page_size)
        return self.index.insert(tokens, self._slot_pages[slot][:n_full],
                                 retain=self._retain, generated=True)

    # ------------------------------------------------------------ install

    def write_slot(self, slot: int, single: Store) -> None:
        """Scatter a prefilled batch-1 cache into the slot's pages (and its
        resident rows). Shared prefix pages receive back the values they
        supplied — a value-level no-op. On a mesh each rank writes its
        share of the heads (a rank outside the mesh holds nothing)."""
        if self._slices is not None:
            if not SH.in_mesh(self.mesh):
                return
            single = [{n: t[_slab_slices(self._slices[i][n],
                                         self.layout.paged[i][n])]
                       for n, t in layer.items()}
                      for i, layer in enumerate(single)]
        self.layout.scatter_one(self.store, self.page_table[slot], slot,
                                single)

    # ------------------------------------------------------ introspection

    def gather_bytes_per_dispatch(self) -> int:
        """Bytes a gather/scatter decode dispatch would move (the slab view
        of the paged leaves, gathered in and scattered back): what the
        page-table-native decode avoids, per dispatch. Static in the
        layout; 0 without a paged leaf."""
        if not self.layout.has_paged:
            return 0
        return 2 * self.layout.slab_view_bytes()

    def bytes(self) -> int:
        """Bytes of the page store (on a mesh, of the whole store, as the
        JAX package's sharded array counts) and the page table."""
        store = self._bytes if self.mesh is not None else sum(
            t.numel() * t.element_size()
            for layer in self.store for t in layer.values())
        return store \
            + self.page_table.numel() * self.page_table.element_size()

    def describe(self) -> Dict[str, Any]:
        """The pool's geometry and occupancy, with the reference's keys;
        leaves are counted as the reference's cache tree holds them (a
        scan slot's layers stacked into one leaf)."""
        return {
            "page_size": self.page_size,
            "pages_per_slot": self.pp,
            "n_pages": self.n_pages,
            "usable_pages": self.n_usable_pages,
            "pages_in_use": self.pages_in_use,
            "prefix_cache": self.index is not None,
            "prefix_nodes": self.index.n_nodes if self.index else 0,
            "bytes": self.bytes(),
            "paged_leaves": self.layout.n_paged_leaves,
            "resident_leaves": self.layout.n_resident_leaves,
        }

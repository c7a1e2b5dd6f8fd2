"""Radix-tree prefix index over token IDs, at page granularity (the port's
own copy of `repro.serve.prefix`: host-side Python, no tensors).

Cross-request redundancy is the serving-side analogue of the weight
redundancy Kratos elides at the fabric: fleets of requests share system
prompts and few-shot preambles whose prefill we recompute — and whose KV we
store once per slot — on every admission. The index maps PAGE-ALIGNED token
prefixes to physical page ids in the paged KV pool (serve.paging): at
admission the engine matches the longest cached prefix, shares its pages by
refcount bump (no memory traffic), and prefills only the unmatched suffix.

Granularity contract: one radix node = one FULL page of `page_size` token
ids, keyed by the token tuple. Matching is therefore always page-aligned —
a partially-covered page is never shared, so sharing needs no copy-on-write
copy: a sharer's first own write lands strictly past the shared pages (its
private suffix pages), and rewinds (speculative rollback) never free a
shared page because freeing is refcount-based.

Ownership contract: the index holds ONE reference per inserted page (the
pool's refcount, bumped via the `retain` callback at insert). Pages whose
only remaining reference is the tree ("unreferenced" prefix pages) are the
eviction currency: `evict` drops LRU LEAF nodes whose page `can_free` (pool
refcount == 1) and releases them back to the free list, stopping at nodes
still shared with a live slot. Interior nodes are never dropped before
their children — prefix contiguity is an invariant of the tree shape.

The structure is host-side bookkeeping only (admission-time, off the hot
decode path); the device never sees it — it sees the page tables the
matches produce.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Node:
    """One full page of tokens: key (token tuple) -> physical page id.

    `generated` marks nodes published at request FINISH (whole-conversation
    reuse: the page covers tokens the model generated, not just prompt
    text) — admission counts a match that touches one as a conversation
    hit, distinct from plain prompt-prefix sharing."""

    __slots__ = ("key", "page", "children", "parent", "last_used",
                 "generated")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], clock: int,
                 generated: bool = False):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.last_used = clock
        self.generated = generated


class PrefixIndex:
    """Radix tree over page-sized token chunks -> physical page ids."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.children: Dict[Tuple[int, ...], _Node] = {}   # root's children
        self.clock = 0                     # logical LRU clock (match/insert)
        self.n_nodes = 0                   # pages currently retained
        self.evicted = 0                   # nodes dropped under pressure

    # ------------------------------------------------------------------ walk

    def _chunks(self, tokens: Sequence[int]):
        p = self.page_size
        for i in range(0, (len(tokens) // p) * p, p):
            yield tuple(int(t) for t in tokens[i:i + p])

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], bool]:
        """(physical pages of the longest page-aligned cached prefix,
        whether any matched node was published at request finish — a
        CONVERSATION hit rather than a prompt-prefix hit).

        Touches every node on the matched path (an LRU hit on a deep prefix
        refreshes its ancestors too — a prefix of a hot prompt is at least
        as hot as the prompt)."""
        self.clock += 1
        children, pages, conversation = self.children, [], False
        for key in self._chunks(tokens):
            node = children.get(key)
            if node is None:
                break
            node.last_used = self.clock
            pages.append(node.page)
            conversation |= node.generated
            children = node.children
        return pages, conversation

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               retain: Callable[[int], None], *,
               generated: bool = False) -> int:
        """Publish `pages` (the physical pages holding the leading full
        token pages of `tokens`) into the tree; returns how many were NEWLY
        retained. Chunks already present keep their existing page (the
        canonical copy — the caller's duplicate simply frees at slot
        release); `retain(page)` is called once per new node so the pool's
        refcount mirrors tree membership exactly. `generated` tags the NEW
        nodes as conversation pages (request-finish publishes); an existing
        node keeps its tag — the prompt-prefix portion of a conversation
        stays a prompt-prefix hit."""
        self.clock += 1
        children, parent, added = self.children, None, 0
        for key, page in zip(self._chunks(tokens), pages):
            node = children.get(key)
            if node is None:
                node = _Node(key, int(page), parent, self.clock,
                             generated=generated)
                children[key] = node
                retain(node.page)
                self.n_nodes += 1
                added += 1
            else:
                node.last_used = self.clock
            parent, children = node, node.children
        return added

    # ------------------------------------------------------------- eviction

    def _iter_nodes(self):
        stack = list(self.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def evict(self, n_pages: int, can_free: Callable[[int], bool],
              release: Callable[[int], None]) -> int:
        """Drop up to `n_pages` LRU LEAF nodes whose page `can_free` (no
        reference left but the tree's own), `release`-ing each page back to
        the pool. Dropping a leaf may expose its parent as the next LRU
        candidate; stops early when every remaining leaf is still shared
        with a live slot. Returns the number of pages actually freed.

        One tree traversal seeds a min-heap of leaves; parents enter the
        heap as their children drop — O(nodes log nodes) per call, not
        O(nodes) per page (admissions under pressure hit this on a tree
        with one node per cached page). Skipped leaves (still referenced)
        never re-enter: our own releases only free TREE-held pages, so no
        other page's refcount changes mid-call."""
        heap = [(n.last_used, id(n), n) for n in self._iter_nodes()
                if not n.children]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_pages:
            _, _, node = heapq.heappop(heap)
            if node.children or not can_free(node.page):
                continue
            owner = node.parent.children if node.parent else self.children
            del owner[node.key]
            release(node.page)
            self.n_nodes -= 1
            self.evicted += 1
            freed += 1
            parent = node.parent
            if parent is not None and not parent.children:
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def clear(self, release: Callable[[int], None]) -> int:
        """Drop every node (shutdown / tests), releasing each page."""
        n = 0
        for node in self._iter_nodes():
            release(node.page)
            n += 1
        self.children = {}
        self.n_nodes = 0
        return n

"""Serving steps (the serving half of `repro.distributed.steps`).

`make_decode_step(n_steps=K)` is the device-resident loop: K micro-steps
run back to back on the device — forward, Gumbel-max / greedy sampling,
per-slot EOS and length masking with `torch.where` — and nothing inside
the loop reads a value back to the host (no `.item()`, `.cpu()` or
`nonzero`). The stacked (K, B) int32 token block is the one thing the
caller copies out per dispatch. The KV slab (or page store) and the loop
state are updated in place on the device. `make_paged_decode_step` is the
native paged form — the page table rides into every forward as device
state — and `make_suffix_prefill_step` prefills only the unmatched suffix
of a prefix-reuse admission. Training steps and speculative decode are not
ported yet (ROADMAP.md queue 1, items 6 and 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg: T.ModelConfig, last_only: bool = True, *,
                      cache_len: int, cache_dtype=torch.float32,
                      device="cuda"):
    """prefill(params, batch) -> (logits, batch-1 caches).

    The step allocates its own batch-1 cache list of `cache_len` positions
    on the device. last_only=False returns (1, S, vocab) logits: the engine
    right-pads prompts into buckets and reads the column at the true end."""
    def prefill(params, batch):
        caches = T.make_caches(cfg, 1, cache_len, cache_dtype, device)
        return T.forward(params, batch["tokens"], cfg, caches=caches,
                         last_only=last_only)
    return prefill


def make_decode_step(cfg: T.ModelConfig, *, n_steps: int,
                     pages_meta: Optional[Dict[str, int]] = None):
    """decode(params, caches, state) -> (tok_block (K, B) int32 on the
    device, caches, state). Slots that finish mid-block (EOS or budget)
    freeze their token and index; the host catches up from the block.

    pages_meta={'size': page_size, 'len': cache_len} builds the native
    paged form, which takes the (n_slots, pp) page table after `caches`:
        decode(params, caches, page_table, state)
            -> (tok_block, caches, page_table, state)
    and threads pages={'table', 'size', 'len'} into every forward. The
    table is loop-invariant inside the dispatch (admission changes it
    between dispatches)."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")

    def decode(params, caches, state, page_table=None):
        pages = None if page_table is None else dict(pages_meta,
                                                     table=page_table)
        toks = []
        st = state
        for _ in range(n_steps):
            logits, caches = T.forward(params, st["tokens"][:, None], cfg,
                                       caches=caches, index=st["index"],
                                       pages=pages)
            tok = T.sample_tokens(logits[:, -1], st["generator"],
                                  st["temperature"])
            active = st["active"]
            tok = torch.where(active, tok, st["tokens"])
            remaining = torch.where(active, st["remaining"] - 1,
                                    st["remaining"])
            hit_eos = active & (st["eos"] >= 0) & (tok == st["eos"])
            st = dict(st, tokens=tok,
                      index=torch.where(active, st["index"] + 1, st["index"]),
                      remaining=remaining,
                      active=active & (remaining > 0) & ~hit_eos)
            toks.append(tok)
        return torch.stack(toks), caches, st

    if pages_meta is not None:
        def paged_decode(params, caches, page_table, state):
            tok_block, caches, state = decode(params, caches, state,
                                              page_table)
            return tok_block, caches, page_table, state
        return paged_decode
    return decode


def make_paged_decode_step(cfg: T.ModelConfig, *, n_steps: int, layout):
    """Native paged form of the device-resident loop (serve.paging):

        decode(params, store, page_table, state)
            -> (tok_block, store, page_table, state)

    The store's leaves pass straight into the forward as its cache list
    and the attention layers read and write them through the table — one
    indexed write per leaf for the new rows, the page-table kernel for the
    read — so no per-dispatch slab view exists."""
    meta = {"size": layout.page_size, "len": layout.cache_len}
    inner = make_decode_step(cfg, n_steps=n_steps, pages_meta=meta)

    def decode(params, store, page_table, state):
        return inner(params, layout.as_tree(store), page_table, state)

    return decode


def make_suffix_prefill_step(cfg: T.ModelConfig, *, layout):
    """Prefill ONLY the unmatched suffix of a prompt whose prefix pages are
    already resident:

        prefill(params, batch, store, page_table, slot, index)
            -> ((1, S, vocab) suffix logits, store)

    Gathers the slot's batch-1 slab-layout view (the shared prefix pages
    supply positions < index), runs the suffix through the decode-form
    forward (the s > 1 contiguous block write, so suffix tokens attend to
    the cached prefix under the validity masks) and scatters the view back
    in place: fresh suffix pages receive the new KV, shared prefix pages
    the values they supplied. `index` is the matched prefix length (a 0-d
    int32 device tensor). Padded suffix rows land past the shared region,
    masked until decode overwrites them; the caller reads the logits
    column at the true suffix end."""
    def prefill(params, batch, store, page_table, slot, index):
        row = page_table[slot]
        caches = layout.gather_one(store, row, slot)
        logits, caches = T.forward(params, batch["tokens"], cfg,
                                   caches=caches, index=index)
        layout.scatter_one(store, row, slot, caches)
        return logits, store

    return prefill


def make_decode_state(n_slots: int, seed: int = 0,
                      device="cuda") -> Dict[str, object]:
    """Device-resident per-slot loop state: the token/index feedback loop,
    per-slot temperature / EOS / remaining budget / active flag (written
    only at admission) and the sampling generator."""
    z = dict(device=device)
    return {
        "tokens": torch.zeros(n_slots, dtype=torch.int32, **z),
        "index": torch.zeros(n_slots, dtype=torch.int32, **z),
        "generator": torch.Generator(device=device).manual_seed(seed),
        "temperature": torch.zeros(n_slots, dtype=torch.float32, **z),
        "eos": torch.full((n_slots,), -1, dtype=torch.int32, **z),
        "remaining": torch.zeros(n_slots, dtype=torch.int32, **z),
        "active": torch.zeros(n_slots, dtype=torch.bool, **z),
    }


def install_slot(state: Dict[str, object], slot: int, token: int, index: int,
                 temperature: float, eos: int, remaining: int) -> None:
    """Write one admitted request's row of the decode state, in place.
    eos < 0 means no EOS; remaining <= 0 installs an inactive row."""
    state["tokens"][slot] = token
    state["index"][slot] = index
    state["temperature"][slot] = temperature
    state["eos"][slot] = eos
    state["remaining"][slot] = remaining
    state["active"][slot] = remaining > 0

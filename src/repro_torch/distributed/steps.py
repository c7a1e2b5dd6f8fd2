"""Serving steps (the serving half of `repro.distributed.steps`).

`make_decode_step(n_steps=K)` is the device-resident loop: K micro-steps
run back to back on the device — forward, Gumbel-max / greedy sampling,
per-slot EOS and length masking with `torch.where` — and nothing inside
the loop reads a value back to the host (no `.item()`, `.cpu()` or
`nonzero`). The stacked (K, B) int32 token block is the one thing the
caller copies out per dispatch. The KV slab and the loop state are updated
in place on the device. Training steps, paged and speculative decode are
not ported yet (ROADMAP.md queue 1, items 5, 6 and 9).
"""

from __future__ import annotations

from typing import Dict

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


def make_decode_step(cfg: T.ModelConfig, *, n_steps: int):
    """decode(params, caches, state) -> (tok_block (K, B) int32 on the
    device, caches, state). Slots that finish mid-block (EOS or budget)
    freeze their token and index; the host catches up from the block."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")

    def decode(params, caches, state):
        toks = []
        st = state
        for _ in range(n_steps):
            logits, caches = T.forward(params, st["tokens"][:, None], cfg,
                                       caches=caches, index=st["index"])
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

    return decode


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

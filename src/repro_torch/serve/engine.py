"""Continuous-batching inference engine over a packed model (port of
`repro.serve.engine`, device-loop path over the slab or the page pool).

Step loop (`step()`):
  1. admission — the scheduler picks arrived requests for free slots; each
     is prefilled alone (batch 1, prompt right-padded to a power-of-two
     bucket where that is exact; at its exact length for a recurrent
     (is_ssm) arch, whose padded positions would enter the state, and for
     an MoE arch, whose pad tokens would take expert capacity) and its
     cache copied into its slab row.
     Under a paged pool (`page_size`) the admission first matches the
     longest cached page-aligned prefix, reserves the slot's pages (shared
     prefix pages by refcount) and prefills only the unmatched suffix; a
     pool short of pages requeues the admission at the front.
     The first token is sampled from the prefill logits (one host sync)
     and the slot's row of the device loop state is installed.
  2. decode — ONE dispatch of `decode_chunk` (K) micro-steps over all
     slots, sampling and EOS / length masking on the device (on the card a
     CUDA graph replay, serve.backend); the (K, B) int32 token block is the
     dispatch's one host sync.
  3. lifecycle — the block is emitted per request in micro-step order,
     finished requests publish their conversation to the prefix index
     (paged) and free their slots for the next step.

Speculative decode (`EngineConfig.speculate=K`, serve.speculative): the
dispatch becomes one propose-then-verify cycle. A self-draft (the target's
weights re-packed at a cheaper Kratos point, `registry.load(...,
draft_spec=...)`) proposes K tokens, the target verifies them, and every
live slot commits 1..K+1 tokens (the caches are padded by K positions).
Greedy output is token-identical to plain decode for any draft and any K;
a request may cap or refuse drafting with `submit(speculate=...)`.

Greedy output is independent of K, of what else shares the slab, and of
paging. QoS tiers, deadlines, bounded pool-wait retries, the legacy
gather/scatter paged decode, the ineffectual-work ledger, tracing and the
host-side decode loop are not ported yet; asking for them raises
`NotImplementedError` naming the ROADMAP.md item.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve import speculative as SP
from repro_torch.serve.backend import LocalBackend
from repro_torch.serve.cache_pool import PoolExhausted
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import PackedModel, check_device
from repro_torch.serve.scheduler import ContinuousScheduler, Request


class EngineSaturated(RuntimeError):
    """The bounded waiting deque is full: admission must spill or retry."""


class ReplicaFault(RuntimeError):
    """A decode sync held out-of-vocab tokens: a corrupted dispatch."""


# field -> (value meaning "off", ROADMAP.md item that ports it)
_NOT_PORTED = {
    "device_loop": (True, "the host-side decode loop baseline: queue 1, item 8"),
    "paged_native": (True, "the legacy gather/scatter paged decode (an A/B "
                     "baseline): queue 1, item 10"),
    "pool_wait_retries": (None, "bounded pool-wait retries: queue 1, item 8"),
    "qos": (None, "QoS tiers: queue 1, item 8"),
    "ledger": (None, "the ineffectual-work ledger: queue 1, item 8"),
    "trace": (None, "tracing: queue 1, item 8"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    max_len: int = 96                  # cache positions per slot
    device: str = "cuda"
    cache_dtype: str = "float32"
    prefill_buckets: bool = True       # pow2 right-padding of prompts
    bucket_min: int = 16
    seed: int = 0                      # sampling generator
    decode_chunk: int = 1              # K micro-steps per dispatch
    max_waiting: Optional[int] = None  # waiting-deque bound (None = open)
    device_loop: bool = True
    # speculative decode (serve.speculative): K draft tokens per propose-
    # then-verify dispatch (0 = off); needs a model loaded with
    # `draft_spec=` and replaces the decode_chunk loop
    speculate: int = 0
    draft_cache_dtype: Optional[str] = None   # None = cache_dtype
    # paged KV + prefix reuse (serve.paging): page_size carves the cache
    # into fixed pages behind per-slot page tables (None = the slab);
    # n_pages sizes the pool (None = slab capacity, n_slots *
    # pages_per_slot, + the sink page); prefix_cache shares page-aligned
    # prompt prefixes through the radix index (off by itself for archs
    # whose cache is not purely positional)
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    prefix_cache: bool = True
    paged_native: bool = True
    pool_wait_retries: Optional[int] = None
    qos: Optional[Any] = None
    ledger: Optional[Any] = None
    trace: Optional[Any] = None

    def __post_init__(self):
        for field, (off, item) in _NOT_PORTED.items():
            if getattr(self, field) != off:
                raise NotImplementedError(
                    f"EngineConfig.{field}: {item} of ROADMAP.md is not "
                    "ported yet")
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{self.decode_chunk}")
        if self.speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {self.speculate}")
        if self.max_waiting is not None and self.max_waiting < 0:
            raise ValueError(f"max_waiting must be >= 0 or None, got "
                             f"{self.max_waiting}")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.n_pages is not None and not self.page_size:
            raise ValueError("n_pages without page_size: the slab pool has "
                             "no page geometry")


class InferenceEngine:
    """Request lifecycle + step loop over a packed model."""

    def __init__(self, model: PackedModel, cfg: EngineConfig = EngineConfig()):
        device = check_device(cfg.device)
        if device.type != model.device.type:
            raise ValueError(f"engine device {device} but model "
                             f"'{model.name}' lives on {model.device}")
        if cfg.speculate:
            SP.refuse_experts(model.cfg)
            if cfg.decode_chunk != 1:
                raise ValueError("speculate replaces decode_chunk: one spec "
                                 "cycle IS the multi-token dispatch; set "
                                 "decode_chunk=1")
            if not model.has_draft:
                raise ValueError(
                    f"speculate={cfg.speculate} needs a self-draft artifact: "
                    f"load the model with registry.load(..., draft_spec=Draft"
                    f"Spec(...)); '{model.name}' has none")
            SP.check_supported(model.cfg, cfg.max_len + cfg.speculate)
        self.model = model
        self.cfg = cfg
        mcfg = model.cfg
        self.scheduler = ContinuousScheduler()
        self.metrics = ServeMetrics()
        if cfg.speculate:
            self.metrics.draft_flop_fraction = model.draft_cost_fraction()
            # target forwards a cycle: one (B, K+1) verify, or K+1
            # single-token steps on a recurrent arch (the steps builder)
            self._verify_steps = cfg.speculate + 1 if mcfg.is_ssm else 1
        self.backend = LocalBackend()
        self.backend.build(model, cfg)
        self.pool = self.backend.pool
        self._vocab = mcfg.vocab
        self._slots: List[Optional[Request]] = [None] * cfg.n_slots
        self._waiting: collections.deque = collections.deque()
        self._next_id = 0
        self.step_count = 0
        self.requests: Dict[int, Request] = {}
        # padding past the window would let the circular prefill evict real
        # positions in favour of pad rows (attention._prefill_cache)
        self._bucket_cap = min([cfg.max_len] + ([mcfg.window] if mcfg.window
                                                else []))
        # pad tokens would run through a recurrence and corrupt the cached
        # conv tail and state, or take expert capacity from real tokens:
        # recurrent and MoE archs prefill at exact length
        self._exact_prefill = bool(mcfg.is_ssm or mcfg.n_experts)
        # pure-SSM state is O(1) and a cache windowed on EVERY layer is
        # circular: such requests may run longer than the slab. gemma2's
        # global layers and MLA's latent cache are positional: bounded
        self._len_bounded = not (
            mcfg.is_ssm
            or (mcfg.window is not None and not mcfg.local_global_period
                and not mcfg.mla))

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               arrival_step: int = 0, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               speculate: Optional[int] = None) -> Request:
        r = Request(id=-1, prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, arrival_step=arrival_step,
                    temperature=temperature, eos_id=eos_id,
                    speculate=speculate)
        if r.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        need = len(r.prompt) + r.max_new_tokens
        if self._len_bounded and need > self.cfg.max_len:
            raise ValueError(f"request needs {need} cache positions (prompt "
                             f"{len(r.prompt)} + gen {r.max_new_tokens}) but "
                             f"max_len={self.cfg.max_len}")
        if self.cfg.max_waiting is not None \
                and len(self._waiting) >= self.cfg.max_waiting:
            self.metrics.on_reject()
            raise EngineSaturated(
                f"waiting deque at max_waiting={self.cfg.max_waiting}")
        r.id = self._next_id
        self._next_id += 1
        self.requests[r.id] = r
        self.metrics.on_submit(r.id, r.arrival_step, len(r.prompt))
        self._waiting.append(r)
        return r

    def step(self) -> None:
        """One engine step: admissions, then one slab decode dispatch."""
        arrived = [r for r in self._waiting
                   if r.arrival_step <= self.step_count]
        admitted = self.scheduler.admissible(arrived, self.pool.n_free)
        if admitted:
            chosen = {r.id for r in admitted}
            self._waiting = collections.deque(
                r for r in self._waiting if r.id not in chosen)
            for i, r in enumerate(admitted):
                try:
                    self._start(r)
                except PoolExhausted:
                    # free slots but not enough free pages, even after LRU
                    # prefix eviction: requeue this and the remaining
                    # admissions at the front in arrival order; finishing
                    # requests release pages for the next step
                    for rr in reversed(admitted[i:]):
                        self._waiting.appendleft(rr)
                    self.metrics.on_pool_wait()
                    break
        if self.pool.n_active:
            advanced = self._decode_spec() if self.cfg.speculate \
                else self._decode_block()
            stats = self.backend.page_stats()
            if stats is not None:           # per-dispatch page-pool gauge
                self.metrics.on_pages(*stats)
        else:
            self.metrics.on_idle_step()
            advanced = 1
        self.step_count += advanced

    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Step until every submitted request completes; returns outputs."""
        limit = max_steps if max_steps is not None else \
            10 * sum(r.max_new_tokens + 2 for r in self.requests.values()) \
            + max([r.arrival_step for r in self.requests.values()], default=0)
        while (self._waiting or self.pool.n_active) and limit > 0:
            self.step()
            limit -= 1
        if self._waiting or self.pool.n_active:
            raise RuntimeError("engine did not drain within the step limit")
        return {rid: np.asarray(r.generated, np.int32)
                for rid, r in self.requests.items()}

    # ------------------------------------------------------------- internals

    def _prefill_len(self, s0: int) -> int:
        if self._exact_prefill or not self.cfg.prefill_buckets:
            return s0
        b = self.cfg.bucket_min
        while b < s0:
            b *= 2
        return b if b <= self._bucket_cap else s0

    def _suffix_len(self, s: int, start: int) -> int:
        """Bucketed suffix-prefill length: pow2 like `_prefill_len`, but
        the padded tail is written (masked) at positions start..start+b, so
        the bucket falls back to exact when it would run past the slot."""
        if self._exact_prefill or not self.cfg.prefill_buckets:
            return s
        b = self.cfg.bucket_min
        while b < s:
            b *= 2
        return b if start + b <= self._bucket_cap else s

    def _emit(self, r: Request, tok: int, step: int) -> None:
        r.generated.append(tok)
        self.metrics.on_token(r.id, step)
        if len(r.generated) >= r.max_new_tokens \
                or (r.eos_id is not None and tok == r.eos_id):
            r.state = "done"
            if self.backend.paged:
                # publish the whole conversation (prompt + generated)
                # before the slot's pages are freed: the chat's next turn
                # then skips prefill over all of it
                self.backend.conversation_insert(
                    np.concatenate([r.prompt,
                                    np.asarray(r.generated, np.int32)]),
                    r.slot)
            self.pool.free(r.slot)
            self._slots[r.slot] = None
            self.metrics.on_finish(r.id, step)

    def _start(self, r: Request) -> None:
        slot = self.pool.alloc()
        s0 = len(r.prompt)
        dev = self.backend.device
        # paged admission: the longest page-aligned cached prefix, then the
        # slot's page-table row (shared prefix pages by refcount, fresh
        # private pages for the rest of prompt + budget + speculative
        # headroom). Pages are sized from the true footprint, never from the
        # prefill bucket: padded writes past it land in the sink page.
        # PoolExhausted propagates to step(), which requeues.
        matched, shared, conv = self.backend.prefix_match(r.prompt)
        try:
            self.backend.alloc_slot_pages(
                slot, s0 + r.max_new_tokens + self.cfg.speculate, shared)
        except PoolExhausted:
            self.pool.free(slot)
            raise
        sp = self._prefill_len(s0)
        tokens = np.zeros((1, sp), np.int32)
        tokens[0, :s0] = r.prompt
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if matched:
            # prefix hit: only the unmatched suffix runs, right-padded into
            # the same pow2 buckets as full prefills (`batch` still carries
            # the whole prompt for a speculating backend's draft)
            s_sfx = s0 - matched
            sfx = np.zeros((1, self._suffix_len(s_sfx, matched)), np.int32)
            sfx[0, :s_sfx] = r.prompt[matched:]
            logits = self.backend.prefill_suffix(
                {"tokens": torch.from_numpy(sfx).to(dev)}, batch, slot,
                matched)
            row = logits[:, s_sfx - 1]
        else:
            logits, caches = self.backend.prefill(batch, exact=sp == s0)
            row = logits[:, -1] if sp == s0 else logits[:, s0 - 1]
            self.backend.write_slot(slot, caches)
        if self.backend.paged:
            # publish the prompt's full pages for later admissions (a no-op
            # without a prefix index)
            self.backend.prefix_insert(r.prompt, slot)
            self.metrics.on_prefix(matched, s0)
            if conv and matched:
                self.metrics.on_conversation_hit(matched)
        r.prefix_matched = matched
        r.state, r.slot, r.index = "running", slot, s0
        self._slots[slot] = r
        self.metrics.on_start(r.id, self.step_count)
        tok = self.backend.first_token(row, r.temperature)
        self.metrics.on_host_sync("prefill")     # the one int32 pulled
        eos = -1 if r.eos_id is None else int(r.eos_id)
        rem = 0 if (r.eos_id is not None and tok == r.eos_id) \
            else r.max_new_tokens - 1
        self.backend.install(slot, tok, r.index, r.temperature, eos, rem,
                             self._spec_limit(r))
        self._emit(r, tok, self.step_count)   # may finish (max_new_tokens 1)

    def _decode_block(self) -> int:
        """ONE dispatch = K fused micro-steps; sync the (K, B) token block
        and catch host bookkeeping up to it."""
        k = self.cfg.decode_chunk
        self.metrics.on_decode_step(self.pool.n_active, self.cfg.n_slots,
                                    micro_steps=k)
        block = self.backend.decode_block()
        self.metrics.on_host_sync("decode")
        live = [s for s in range(self.cfg.n_slots)
                if self._slots[s] is not None]
        sub = block[:, live]
        if sub.size and (int(sub.min()) < 0 or int(sub.max()) >= self._vocab):
            raise ReplicaFault(f"decode sync outside [0, {self._vocab}): "
                               "corrupted dispatch")
        for j in range(k):
            for slot in range(self.cfg.n_slots):
                r = self._slots[slot]
                if r is None:
                    continue
                r.index += 1
                self._emit(r, int(block[j, slot]), self.step_count + j)
        return k

    def _spec_limit(self, r: Request) -> int:
        """Per-slot speculation cap: the engine's K, clamped by the
        request's own `speculate` (0 = opt out). It is installed on the
        device and is the metrics' proposed-token count, so a capped slot
        proposes only up to its cap."""
        if not self.cfg.speculate:
            return 0
        if r.speculate is None:
            return self.cfg.speculate
        return max(0, min(r.speculate, self.cfg.speculate))

    def _decode_spec(self) -> int:
        """ONE propose-then-verify dispatch commits 1..K+1 tokens per live
        slot. Its one host sync carries (commit block, commit counts,
        accepted counts); the host replays each slot's committed prefix in
        order, and the engine clock advances by the deepest commit."""
        k = self.cfg.speculate
        n = self.cfg.n_slots
        self.metrics.on_decode_step(self.pool.n_active, n,
                                    micro_steps=(k + 1) + self._verify_steps)
        block, n_commit, n_accept = self.backend.spec_decode_block()
        self.metrics.on_host_sync("decode")
        # fault detection: every live slot's committed prefix is checked
        # BEFORE anything is emitted
        for slot in range(n):
            if self._slots[slot] is None:
                continue
            m = int(n_commit[slot])
            if not 0 <= m <= k + 1 or (m and (
                    int(block[slot, :m].min()) < 0
                    or int(block[slot, :m].max()) >= self._vocab)):
                raise ReplicaFault(
                    f"speculative sync outside [0, {self._vocab}) or commit "
                    f"count {m} out of [0, {k + 1}]: corrupted dispatch")
        advanced, proposed, accepted = 1, 0, 0
        for slot in range(n):
            r = self._slots[slot]
            if r is None:
                continue
            m = int(n_commit[slot])
            # a draft token could commit only within the slot's remaining
            # budget: the proposed count is clamped to it
            lim = min(self._spec_limit(r),
                      r.max_new_tokens - len(r.generated))
            advanced = max(advanced, m)
            for j in range(m):
                r.index += 1
                self._emit(r, int(block[slot, j]), self.step_count + j)
            if r.done and r.eos_id is not None and m \
                    and int(block[slot, m - 1]) == r.eos_id:
                # EOS ended the request mid-block: later columns never had
                # a chance to commit either
                lim = min(lim, m)
            proposed += lim
            acc = int(n_accept[slot])
            accepted += acc
            if lim:
                self.metrics.on_slot_speculation(slot, acc, lim)
        self.metrics.on_spec_dispatch(proposed=proposed, accepted=accepted)
        return advanced

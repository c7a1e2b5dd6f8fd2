"""Continuous-batching inference engine over a packed model (port of
`repro.serve.engine`, device-loop path over the slab or the page pool).

Step loop (`step()`):
  1. admission — the scheduler picks arrived requests for free slots; each
     is prefilled alone (batch 1, prompt right-padded to a power-of-two
     bucket where that is exact; at its exact length for a recurrent arch
     (pure Mamba or the hybrid), whose padded positions would enter the
     state, for an MoE arch, whose pad tokens would take expert
     capacity, and for the encoder-decoder, as the JAX package does) and
     its cache copied into its slab row. A vision-stub request's image
     rows (`submit(extras={"img_embeds": ...})`) are prepended to its
     prompt: positions, pages and the decode clock count them. An
     encoder-decoder request's audio frames (`extras={"frames": ...}`) run
     through the encoder at admission, whose output the decoder's
     cross-attention writes into the slot's cross leaves. Prefix reuse
     skips a request with extras.
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
Every arch family speculates. Greedy output equals plain decode for any
draft and any K, except on an MoE arch whose capacity drops assignments:
its verify routes other groups than plain decode (each slot's (K+1) block
alone; on the hybrid, K+1 steps that route the other slots' draft tokens),
so there the two part, as in the JAX package. A request may cap or refuse
drafting with `submit(speculate=...)`.

The host-side decode loop (`EngineConfig(device_loop=False)`) is the
measured baseline of the device loop: every step runs one (B, 1) forward
(on the card a CUDA graph replay of it), pulls the full-vocab logits of
the last column to the host, samples there with
`np.random.default_rng(seed)` (argmax, or Gumbel noise on logits / T in
float64) and uploads the token and index vectors for the next step: three
host syncs a decode step. It serves the slab only and does not speculate.

Resilience (serve.qos): a request may carry deadlines (`deadline_steps`
on the deterministic engine-step clock, `deadline_ms` on the wall).
Admission sheds work that is already doomed, and a per-step sweep sheds
waiting and running requests the moment they cannot finish in time,
freeing the slot and pages (`Request.state == "shed"`, `shed_reason`);
`cancel(r)` does the same on demand. `EngineConfig.pool_wait_retries`
bounds the PoolExhausted requeue with an exponential step backoff, then
sheds. `EngineConfig.qos` moves the live decode onto a cheaper resident
(sparsity, bits) tier of the same weights under queue or page pressure
(`set_tier`; the cache is shared, so every stream continues) and promotes
it back with hysteresis.

The ineffectual-work ledger (`EngineConfig.ledger`, serve.ledger) counts
activation zeros, near-zeros and dead k-blocks at the packed GEMMs on the
device, inside every dispatch; its matrix comes back in the dispatch's one
host copy and drains into `metrics` and `engine.ledger`. With
`LedgerConfig.quality_every` every Nth full-prefill admission is
shadow-run through tier 0 for top-1 agreement and mean |logit
difference| per tier (`metrics.quality_by_tier()`, `quality_log`).

Tracing (`EngineConfig.trace`, serve.trace): a `Tracer` records every
lifecycle and dispatch edge at the JAX engine's call sites (submit,
reject, admit, prefill, first token, finish, each dispatch with its
wall duration, host syncs, page traffic, pool waits, tier changes, sheds,
failovers, the ledger's fractions and the quality probe); without it the
engine holds `NULL_TRACER`, whose hooks allocate nothing. The hooks sit
outside `backend.decode_block` / `spec_decode_block`, so none runs inside
a CUDA-graph capture or replay, and a traced engine launches exactly the
kernels an untraced one does. A `host_sync` event's `bytes` are what the
copy moves: the (K, B) int32 token block (the speculative (B, K+3) block,
the host loop's (B, vocab) f32 logits pull plus the token and index
uploads), as in the JAX package, plus, with the ledger on, the ledger's
(n_layers, width) matrix that rides the same copy in the port (the JAX
package drains its ledger inside the same sync but counts only the
tokens).

Failover (serve.router): `steal_waiting`, `evacuate` (every slot's pages
and loop-state row released, a running request's generated tokens folded
into its prompt so a survivor's greedy re-prefill resumes the stream) and
`adopt`, which budgets what a resumed request still owes and counts the
failover. A corrupted decode sync raises `ReplicaFault`, the router's
signal.

Greedy output is independent of K, of what else shares the slab, of the
admission policy, and of paging, native or the legacy gather/scatter form
(`paged_native=False`); on an MoE arch, as far as capacity routing lets
it (ROADMAP.md queue 3).

The engine takes its admission policy, metrics sink and execution backend
as arguments (`scheduler=`, `metrics=`, `backend=`; by default a
`ContinuousScheduler`, a fresh `ServeMetrics` and a `LocalBackend`), as
the JAX engine does.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve import speculative as SP
from repro_torch.serve.backend import ExecutionBackend, LocalBackend
from repro_torch.serve.cache_pool import PoolExhausted
from repro_torch.serve.ledger import NULL_LEDGER, LedgerSink
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.qos import QoSController
from repro_torch.serve.registry import PackedModel, check_device
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         SchedulerBase)
from repro_torch.serve.trace import NULL_TRACER, TraceConfig, Tracer


class EngineSaturated(RuntimeError):
    """The bounded waiting deque is full: admission must spill or retry."""


class ReplicaFault(RuntimeError):
    """The replica produced provably corrupt output (an out-of-vocab decode
    sync) or its dispatch crashed. The replica router catches it around
    `engine.step()`, marks the replica dead and re-admits its evacuated
    requests to survivors."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    max_len: int = 96                  # cache positions per slot
    device: str = "cuda"
    cache_dtype: str = "float32"
    prefill_buckets: bool = True       # pow2 right-padding of prompts
    bucket_min: int = 16
    seed: int = 0                      # sampling generator
    device_loop: bool = True
    decode_chunk: int = 1              # K micro-steps per dispatch
    max_waiting: Optional[int] = None  # waiting-deque bound (None = open)
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
    # whose cache is not purely positional); paged_native=False decodes
    # through the legacy gather / slab step / scatter form (the A/B
    # baseline of the page-table-native decode)
    page_size: Optional[int] = None
    n_pages: Optional[int] = None
    prefix_cache: bool = True
    paged_native: bool = True
    # resilience (serve.qos): pool_wait_retries bounds the PoolExhausted
    # requeue of a request (None = the unbounded requeue at the front; N =
    # an exponential step backoff, then shed past N retries); qos (a
    # QoSConfig) moves the decode between resident tiers under load and
    # needs a model loaded with tier_specs
    pool_wait_retries: Optional[int] = None
    qos: Optional[Any] = None
    # tracing (serve.trace): None = off, the shared allocation-free
    # NULL_TRACER; a TraceConfig records every edge into the ring buffer,
    # with optional export paths and a torch.profiler bracket
    trace: Optional[TraceConfig] = None
    # the ineffectual-work ledger (a serve.ledger.LedgerConfig; None = off,
    # the allocation-free NULL_LEDGER); needs device_loop=True
    ledger: Optional[Any] = None

    def __post_init__(self):
        # the JAX engine's checks, with its messages
        if not self.device_loop:
            if self.decode_chunk > 1:
                raise ValueError("decode_chunk > 1 requires device_loop=True "
                                 "(the host loop samples every micro-step)")
            if self.page_size:
                raise ValueError("page_size requires device_loop=True (the "
                                 "page-table decode lives inside the fused "
                                 "dispatch; the host loop has no paged form)")
            if self.ledger is not None:
                raise ValueError("ledger requires device_loop=True (the "
                                 "counter matrix rides the fused dispatch's "
                                 "loop state; the host loop has no fused "
                                 "step)")
            if self.speculate:
                raise ValueError("speculate requires device_loop=True (the "
                                 "propose-then-verify cycle is one fused "
                                 "dispatch)")
        if self.decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{self.decode_chunk}")
        if self.speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {self.speculate}")
        if self.pool_wait_retries is not None and self.pool_wait_retries < 0:
            raise ValueError(f"pool_wait_retries must be >= 0 or None, got "
                             f"{self.pool_wait_retries}")
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

    def __init__(self, model: PackedModel, cfg: EngineConfig = EngineConfig(),
                 scheduler: Optional[SchedulerBase] = None,
                 metrics: Optional[ServeMetrics] = None,
                 backend: Optional[ExecutionBackend] = None):
        device = check_device(cfg.device)
        if device.type != model.device.type:
            raise ValueError(f"engine device {device} but model "
                             f"'{model.name}' lives on {model.device}")
        if cfg.speculate:
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
        self.scheduler = ContinuousScheduler() if scheduler is None \
            else scheduler
        self.metrics = ServeMetrics() if metrics is None else metrics
        if cfg.speculate:
            self.metrics.draft_flop_fraction = model.draft_cost_fraction()
            # target forwards a cycle: one (B, K+1) verify, or K+1
            # single-token steps on a recurrent arch, pure Mamba or the
            # hybrid (the steps builder)
            self._verify_steps = cfg.speculate + 1 \
                if (mcfg.is_ssm or mcfg.attn_period) else 1
        self.backend = LocalBackend() if backend is None else backend
        self.backend.build(model, cfg)
        self.pool = self.backend.pool
        # bytes a gather/scatter paged decode would move per dispatch (0 on
        # the slab and on the legacy paged form)
        self._gather_bytes = self.backend.gather_bytes_per_dispatch()
        self.trace = NULL_TRACER if cfg.trace is None else Tracer(
            cfg.trace, device=device.type)
        self.pool.tracer = self.trace
        if self.backend.draft_pool is not None:
            self.backend.draft_pool.tracer = self.trace
        self._qos = None if cfg.qos is None else \
            QoSController(cfg.qos, self.backend.n_tiers)
        self._has_deadlines = False     # arms the per-step deadline sweep
        # the ledger's sink folds each dispatch's drained delta into
        # float64 totals and the metrics; NULL_LEDGER keeps the disabled
        # path allocation-free
        self.ledger = NULL_LEDGER if cfg.ledger is None else LedgerSink(
            cfg.ledger, mcfg.n_layers, metrics=self.metrics,
            tracer=self.trace)
        self._quality_every = 0 if cfg.ledger is None \
            else cfg.ledger.quality_every
        self._quality_count = 0         # full-prefill admissions since probe
        self.quality_log: List[Dict[str, Any]] = []
        self._vocab = mcfg.vocab
        # the dispatch's host-copy payload, precomputed so that every hot
        # call passes values that already exist: the token block (the
        # speculative commit block, counts and accepts; the host loop's
        # logits pull and token and index uploads), plus the ledger's
        # matrix where it rides the copy
        b = cfg.n_slots
        if cfg.speculate:
            self._sync_bytes = 4 * b * (cfg.speculate + 3)
        elif cfg.device_loop:
            self._sync_bytes = 4 * b * cfg.decode_chunk
        else:
            self._sync_bytes = 4 * b * (mcfg.vocab + 2)
        if cfg.ledger is not None:
            self._sync_bytes += 4 * mcfg.n_layers * cfg.ledger.width
        if not cfg.device_loop:
            # the host loop's token and index vectors, uploaded every step
            self._tokens = np.zeros((cfg.n_slots, 1), np.int32)
            self._indices = np.zeros((cfg.n_slots,), np.int32)
        self._rng = np.random.default_rng(cfg.seed)
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
        # recurrent (pure Mamba, hybrid) and MoE archs prefill at exact
        # length; the encoder-decoder does too, as the JAX package's engine
        self._exact_prefill = bool(mcfg.is_ssm or mcfg.attn_period
                                   or mcfg.n_experts or mcfg.enc_dec)
        # pure-SSM state is O(1) and a cache windowed on EVERY layer is
        # circular: such requests may run longer than the slab. gemma2's
        # global layers, MLA's latent cache and the hybrid's attention
        # layer, and the encoder-decoder's decoder, are positional: bounded
        self._len_bounded = not (
            mcfg.is_ssm
            or (mcfg.window is not None and not mcfg.local_global_period
                and not mcfg.mla and not mcfg.attn_period
                and not mcfg.enc_dec))
        # a page pool pages a window no shorter than max_len (llava's 4096
        # over max_len 3456): its table ends at max_len, so such a request
        # is bounded there (the JAX package's paged engine clamps the table
        # lookup past it and writes into the slot's last page)
        self._len_bounded |= bool(self.backend.paged
                                  and self.pool.layout.has_paged)
        self._n_img = mcfg.n_img_tokens

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               arrival_step: int = 0, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               extras: Optional[Dict[str, Any]] = None,
               on_token=None, speculate: Optional[int] = None,
               deadline_steps: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               slo: str = "") -> Request:
        """Queue a request. extras: model inputs besides the tokens, batch-1
        leading: a vision-stub arch's {"img_embeds": (1, n_img_tokens, d)}
        (models.frontends.llava_patches), or an encoder-decoder's {"frames":
        (1, enc_positions, d)} (models.frontends.whisper_frames).
        on_token(request, token) streams each emitted token; the deadlines
        shed the request once it cannot finish in time (a request already
        doomed is shed here and returned, never queued)."""
        r = Request(id=-1, prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, arrival_step=arrival_step,
                    temperature=temperature, eos_id=eos_id,
                    speculate=speculate, extras=extras, on_token=on_token,
                    deadline_steps=deadline_steps, deadline_ms=deadline_ms,
                    slo=slo)
        return self.adopt(r)

    def adopt(self, r: Request) -> Request:
        """Validate and enqueue a Request object: a fresh submit, a waiting
        request the replica router moved here, or one evacuated off a dead
        replica (`failover_from` set) resuming its generation here. Raises
        EngineSaturated when the bounded waiting deque is full; sheds (and
        returns) a request whose deadline provably cannot be met."""
        if r.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # an evacuated request folded its output into the prompt and keeps
        # `generated`: the budget is what is still owed
        budget = r.max_new_tokens - len(r.generated)
        need = self._n_img + len(r.prompt) + budget
        if self._len_bounded and need > self.cfg.max_len:
            raise ValueError(f"request needs {need} cache positions (img "
                             f"{self._n_img} + prompt {len(r.prompt)} + gen "
                             f"{budget}) but max_len={self.cfg.max_len}")
        if self.cfg.max_waiting is not None \
                and len(self._waiting) >= self.cfg.max_waiting:
            self.metrics.on_reject()
            self.trace.reject(len(self._waiting))
            raise EngineSaturated(
                f"waiting deque at max_waiting={self.cfg.max_waiting}")
        r.id = self._next_id
        self._next_id += 1
        self.requests[r.id] = r
        self.metrics.on_submit(r.id, r.arrival_step, len(r.prompt))
        self.trace.submit(r.id, len(r.prompt), r.arrival_step)
        if r.failover_from >= 0:
            # counted on the destination replica (sums cleanly in the
            # fleet aggregate)
            self.metrics.on_failover()
            self.trace.failover(r.id, r.failover_from)
            r.failover_from = -1
        if r.deadline_steps is not None or r.deadline_ms is not None:
            self._has_deadlines = True
            if self._doomed(r):
                # shedding doomed work now costs nothing and keeps its
                # place in the queue for requests that can still make it
                self._shed(r, "deadline")
                return r
        self._waiting.append(r)
        return r

    def steal_waiting(self, n: int) -> List[Request]:
        """Pop up to `n` waiting (never started) requests off the tail of
        the deque, the ones that would wait longest here, de-registering
        them from this engine. The router re-`adopt`s them into an
        underloaded replica; the Request objects survive the move."""
        out: List[Request] = []
        while self._waiting and len(out) < n:
            r = self._waiting.pop()
            del self.requests[r.id]
            self.metrics.records.pop(r.id, None)
            r.id = -1
            out.append(r)
        return out[::-1]                # keep their arrival order

    def cancel(self, r: Request, reason: str = "cancel") -> None:
        """Cancel a request: the terminal "shed" state, its slot, pages
        (and the draft's slab row, which shares the slot) and prefix
        references released. A no-op on a finished request."""
        if r.finished or r.id not in self.requests:
            return
        if r.state == "waiting":
            try:
                self._waiting.remove(r)
            except ValueError:
                pass
        self._shed(r, reason)

    def evacuate(self) -> List[Request]:
        """Strip every unfinished request off this engine for re-admission
        elsewhere (router failover). A running request folds what it
        generated into its prompt and returns to waiting: a survivor's
        greedy re-prefill of the whole history rebuilds the causal cache
        exactly, so the resumed stream equals an uninterrupted run. Each
        slot's pages and loop-state row are released; requests and their
        records are de-registered here (the router re-adopts them, so no
        completion is counted twice)."""
        out: List[Request] = []
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            try:
                if self.cfg.device_loop:
                    self.backend.release_slot(slot)
                self.pool.free(slot)
            except RuntimeError:
                pass    # a faulted device may refuse the writes; this
                #         replica is being torn down anyway
            self._slots[slot] = None
            if r.generated:
                r.prompt = np.concatenate(
                    [r.prompt, np.asarray(r.generated, np.int32)])
            r.state = "waiting"
            r.slot, r.index, r.prefix_matched = -1, 0, 0
            out.append(r)
        out.extend(self._waiting)
        self._waiting.clear()
        for r in out:
            self.requests.pop(r.id, None)
            self.metrics.records.pop(r.id, None)
            r.id = -1
        return out

    # -- QoS tiers (serve.qos) ----------------------------------------------

    @property
    def tier(self) -> int:
        """The live quality tier (0 = the model's own spec)."""
        return self.backend.tier

    def set_tier(self, tier: int) -> None:
        """Swap the live decode onto packed tier `tier`. Resident requests
        continue from their exact position; each records the cheapest tier
        it decoded on."""
        old = self.backend.tier
        if tier == old:
            return
        self.backend.set_tier(tier)
        self.metrics.on_tier_change(old, tier)
        self.trace.tier_change(old, tier, len(self._waiting))
        for r in self._slots:
            if r is not None and tier > r.tier:
                r.tier = tier
                self.trace.req_tier(r.id, tier)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    def step(self) -> None:
        """One engine step: the deadline sweep and the QoS tick, then
        admissions, then one slab decode dispatch."""
        self.trace.step = self.step_count
        self._expire_deadlines()
        if self._qos is not None:
            self._qos_tick()
        arrived = [r for r in self._waiting
                   if r.arrival_step <= self.step_count
                   and r.retry_at_step <= self.step_count]
        admitted = self.scheduler.admissible(arrived, self.pool.n_active,
                                             self.pool.n_free)
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
                    # requests release pages. With pool_wait_retries the
                    # failed admission waits out an exponential step
                    # backoff (other arrivals keep being tried) and is shed
                    # past the cap.
                    cap = self.cfg.pool_wait_retries
                    r.pool_retries += 1
                    rest = admitted[i + 1:]
                    if cap is not None and r.pool_retries > cap:
                        self._shed(r, "pool")
                    else:
                        if cap is not None:
                            r.retry_at_step = self.step_count + min(
                                1 << r.pool_retries, 64)
                        rest = [r] + rest
                    for rr in reversed(rest):
                        self._waiting.appendleft(rr)
                    self.metrics.on_pool_wait()
                    self.trace.pool_wait()
                    break
        if self.pool.n_active:
            if self.cfg.speculate:
                advanced = self._decode_spec()
            elif self.cfg.device_loop:
                advanced = self._decode_block()
            else:
                advanced = self._decode_step_host()
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

    def _doomed(self, r: Request) -> bool:
        """True when the request provably cannot finish by its deadline.
        Step clock: a live slot emits at least one token a step (at most 1
        + its speculation cap: the optimistic bound, so a salvageable
        request is never shed early), so the earliest finish is start +
        ceil(remaining / per_step) - 1. Wall clock: the time since
        submit against deadline_ms."""
        if r.deadline_ms is not None:
            rec = self.metrics.records.get(r.id)
            if rec is not None and (time.perf_counter() - rec.submit_mono) \
                    * 1e3 > r.deadline_ms:
                return True
        d = r.deadline_step()
        if d is None:
            return False
        rem = r.max_new_tokens - len(r.generated)
        per = 1 + self._spec_limit(r)
        start = max(self.step_count, r.arrival_step)
        return start - (-rem // per) - 1 > d        # ceil division

    def _shed(self, r: Request, reason: str) -> None:
        """The terminal "shed" state ('deadline' | 'pool' | 'failover' |
        'cancel'): the
        slot's loop-state row parked, the slot and its pages freed (prefix
        references drop with them); never a completion."""
        if r.state == "running":
            if self.cfg.device_loop:
                self.backend.release_slot(r.slot)
            self.pool.free(r.slot)
            self._slots[r.slot] = None
        r.state = "shed"
        r.shed_reason = reason
        self.metrics.on_shed(reason)
        self.trace.shed(r.id, r.slot, reason, len(r.generated))

    def _expire_deadlines(self) -> None:
        """The per-step sweep, armed once a deadline exists: shed waiting
        and running requests the moment they are doomed, so no completion
        is served past its deadline."""
        if not self._has_deadlines:
            return
        expired = [r for r in self._waiting if self._doomed(r)]
        if expired:
            dead = {r.id for r in expired}
            self._waiting = collections.deque(
                r for r in self._waiting if r.id not in dead)
            for r in expired:
                self._shed(r, "deadline")
        for r in list(self._slots):
            if r is not None and self._doomed(r):
                self._shed(r, "deadline")

    def _qos_tick(self) -> None:
        """Feed the tier controller this step's load (queue depth and page
        pool fullness) and apply its verdict."""
        stats = self.backend.page_stats()
        frac = 0.0
        if stats is not None:
            used, usable = stats
            frac = used / max(1, usable)
        want = self._qos.observe(len(self._waiting), frac)
        if want != self.backend.tier:
            self.set_tier(want)

    def _emit(self, r: Request, tok: int, step: int) -> None:
        r.generated.append(tok)
        self.metrics.on_token(r.id, step)
        if len(r.generated) == 1:
            # the emission micro-step (not tracer.step): within a K-block
            # it runs ahead of the dispatch clock, and spans reconcile with
            # ServeMetrics
            self.trace.first_token(r.id, r.slot, step)
        if r.on_token is not None:
            r.on_token(r, tok)
        if len(r.generated) >= r.max_new_tokens \
                or (r.eos_id is not None and tok == r.eos_id):
            r.state = "done"
            self.trace.finish(r.id, r.slot, step, len(r.generated))
            if self.backend.paged and not r.extras:
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
        n_img = self._n_img
        dev = self.backend.device
        # what is still owed: a failover-resumed request already generated
        # part of its budget (now folded into the prompt)
        budget = r.max_new_tokens - len(r.generated)
        # paged admission: the longest page-aligned cached prefix (none for
        # a request with extras: the index keys tokens only), then the
        # slot's page-table row (shared prefix pages by refcount, fresh
        # private pages for the image rows, the rest of the prompt, the
        # budget and the speculative headroom). Pages are sized from the
        # true footprint, never from the prefill bucket: padded writes past
        # it land in the sink page. PoolExhausted propagates to step(),
        # which requeues.
        matched, shared, conv = (0, [], False) if r.extras else \
            self.backend.prefix_match(r.prompt)
        try:
            self.backend.alloc_slot_pages(
                slot, n_img + s0 + budget + self.cfg.speculate,
                shared)
        except PoolExhausted:
            self.pool.free(slot)
            raise
        sp = self._prefill_len(s0)
        tokens = np.zeros((1, sp), np.int32)
        tokens[0, :s0] = r.prompt
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if r.extras:
            batch.update({k: torch.as_tensor(v).to(dev)
                          for k, v in r.extras.items()})
        if matched:
            # prefix hit: only the unmatched suffix runs, right-padded into
            # the same pow2 buckets as full prefills (`batch` still carries
            # the whole prompt for a speculating backend's draft)
            s_sfx = s0 - matched
            sp_sfx = self._suffix_len(s_sfx, matched)
            sfx = np.zeros((1, sp_sfx), np.int32)
            sfx[0, :s_sfx] = r.prompt[matched:]
            logits = self.backend.prefill_suffix(
                {"tokens": torch.from_numpy(sfx).to(dev)}, batch, slot,
                matched)
            row = logits[:, s_sfx - 1]
        else:
            logits, caches = self.backend.prefill(batch, exact=sp == s0)
            col = -1 if sp == s0 else n_img + s0 - 1
            row = logits[:, col]
            self.backend.write_slot(slot, caches)
            if self._quality_every:
                # every quality_every-th full-prefill admission (a prefix
                # hit's suffix logits depend on page state a standalone
                # prefill cannot replay)
                self._quality_count += 1
                if self._quality_count >= self._quality_every:
                    self._quality_count = 0
                    self._quality_probe(r, batch, row, sp == s0, col)
        if self.backend.paged:
            if not r.extras:
                # publish the prompt's full pages for later admissions (a
                # no-op without a prefix index)
                self.backend.prefix_insert(r.prompt, slot)
            self.metrics.on_prefix(matched, s0)
            if conv and matched:
                self.metrics.on_conversation_hit(matched)
                self.trace.conversation_hit(r.id, matched)
        r.prefix_matched = matched
        r.state, r.slot, r.index = "running", slot, n_img + s0
        r.tier = max(r.tier, self.backend.tier)
        self._slots[slot] = r
        self.metrics.on_start(r.id, self.step_count)
        self.trace.admit(r.id, slot, matched, s0)
        self.trace.req_tier(r.id, self.backend.tier)
        if matched:
            self.trace.prefill(r.id, slot, s_sfx, sp_sfx, True)
        else:
            self.trace.prefill(r.id, slot, s0, sp, False)
        if self.cfg.device_loop:
            tok = self.backend.first_token(row, r.temperature)
            self.metrics.on_host_sync("prefill")     # the one int32 pulled
            self.trace.host_sync("prefill", 4)
            eos = -1 if r.eos_id is None else int(r.eos_id)
            rem = 0 if (r.eos_id is not None and tok == r.eos_id) \
                else budget - 1
            self.backend.install(slot, tok, r.index, r.temperature, eos, rem,
                                 self._spec_limit(r))
        else:
            tok = self._sample_host(row[0].float().cpu().numpy(), r)
            self.metrics.on_host_sync("prefill")
            self.trace.host_sync("prefill", 4)
            self._tokens[slot, 0] = tok
            self._indices[slot] = r.index
        self._emit(r, tok, self.step_count)   # may finish (max_new_tokens 1)

    def _quality_probe(self, r: Request, batch, row, exact: bool,
                       col: int) -> None:
        """The per-tier quality probe (serve.ledger): this admission's
        prefill shadow-run through tier 0, its logits column against the
        live tier's on the host: top-1 agreement and mean |logit
        difference|. Two host pulls, metered as 'quality', so
        `host_syncs_decode` stays the dispatch count."""
        shadow = self.backend.quality_shadow(batch, exact)
        ref = np.asarray(shadow[:, col][0], np.float64)
        mine = row[0].float().cpu().numpy().astype(np.float64)
        self.metrics.on_host_sync("quality", 2)
        self.trace.host_sync("quality", 8 * mine.size)
        top1 = bool(int(np.argmax(mine)) == int(np.argmax(ref)))
        mad = float(np.mean(np.abs(mine - ref)))
        tier = self.backend.tier
        self.metrics.on_quality_probe(tier, top1, mad)
        self.trace.quality_probe(r.id, tier, top1, mad)
        self.quality_log.append({"rid": r.id, "tier": tier,
                                 "top1": top1, "mad": mad})

    def _after_dispatch(self) -> None:
        """The bookkeeping every device-loop dispatch shares after its
        copy: the gather bytes a paged dispatch avoided, the one host sync,
        the ledger matrix the copy brought back folded into the sink (a
        no-op without the ledger; rebased when the backend zeroed the
        device buffer), and the tracer's drop count mirrored into the
        metrics (an int store: allocation-free untraced)."""
        if self._gather_bytes:
            self.metrics.on_gather_avoided(self._gather_bytes)
            self.trace.gather_avoided(self._gather_bytes)
        self.metrics.on_host_sync("decode")
        self.trace.host_sync("decode", self._sync_bytes)
        self.ledger.on_drain(self.backend.last_ledger, self.step_count)
        if self.ledger.enabled and self.backend.maybe_rebase_ledger():
            self.ledger.rebase()
        self.metrics.trace_dropped = self.trace.dropped

    def _decode_block(self) -> int:
        """ONE dispatch = K fused micro-steps; sync the (K, B) token block
        and catch host bookkeeping up to it."""
        k = self.cfg.decode_chunk
        n_active = self.pool.n_active
        self.metrics.on_decode_step(n_active, self.cfg.n_slots,
                                    micro_steps=k)
        self.trace.dispatch_begin()
        block = self.backend.decode_block()
        self.trace.decode_dispatch(k, n_active, self.cfg.n_slots)
        # the ledger rode the dispatch's copy: no extra crossing
        self._after_dispatch()
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

    def _sample_host(self, row: np.ndarray, r: Request) -> int:
        if r.temperature <= 0.0:
            return int(np.argmax(row))
        logits = row.astype(np.float64) / r.temperature
        g = self._rng.gumbel(size=logits.shape)
        return int(np.argmax(logits + g))

    def _decode_step_host(self) -> int:
        """The host loop's step: one (B, 1) forward, its last column's
        full-vocab logits pulled, sampling on the host, the token and index
        vectors uploaded for the next step."""
        n_active = self.pool.n_active
        self.metrics.on_decode_step(n_active, self.cfg.n_slots)
        self.trace.dispatch_begin()
        rows = self.backend.decode_host(self._tokens, self._indices)
        self.trace.decode_dispatch(1, n_active, self.cfg.n_slots)
        # logits pull + token and index uploads: 3 crossings a step
        self.metrics.on_host_sync("decode", 3)
        self.trace.host_sync("decode", self._sync_bytes)
        self.metrics.trace_dropped = self.trace.dropped
        for slot, r in enumerate(self._slots):
            if r is None:
                continue
            r.index += 1
            self._indices[slot] = r.index
            tok = self._sample_host(rows[slot], r)
            self._tokens[slot, 0] = tok
            self._emit(r, tok, self.step_count)
        return 1

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
        n_active = self.pool.n_active
        self.metrics.on_decode_step(n_active, n,
                                    micro_steps=(k + 1) + self._verify_steps)
        self.trace.dispatch_begin()
        block, n_commit, n_accept = self.backend.spec_decode_block()
        self.trace.spec_dispatch(k, n_active, n)
        self._after_dispatch()
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
                self.trace.spec_slot(slot, acc, m, lim)
        self.metrics.on_spec_dispatch(proposed=proposed, accepted=accepted)
        return advanced

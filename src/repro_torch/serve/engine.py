"""Continuous-batching inference engine over a packed model (port of
`repro.serve.engine`, slab + device-loop path).

Step loop (`step()`):
  1. admission — the scheduler picks arrived requests for free slots; each
     is prefilled alone (batch 1, prompt right-padded to a power-of-two
     bucket where that is exact) and its cache copied into its slab row.
     The first token is sampled from the prefill logits (one host sync)
     and the slot's row of the device loop state is installed.
  2. decode — ONE dispatch of `decode_chunk` (K) micro-steps over all
     slots, sampling and EOS / length masking on the device; the (K, B)
     int32 token block is the dispatch's one host sync.
  3. lifecycle — the block is emitted per request in micro-step order,
     finished requests free their slots for the next step.

Greedy output is independent of K and of what else shares the slab.
Paging, speculation, QoS tiers, deadlines, the ineffectual-work ledger,
tracing and the host-side decode loop are not ported yet; asking for them
raises `NotImplementedError` naming the ROADMAP.md item.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.backend import LocalBackend
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
    "speculate": (0, "speculative decode: queue 1, item 6"),
    "page_size": (None, "paged KV: queue 1, item 5"),
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
    speculate: int = 0
    page_size: Optional[int] = None
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
        if self.max_waiting is not None and self.max_waiting < 0:
            raise ValueError(f"max_waiting must be >= 0 or None, got "
                             f"{self.max_waiting}")


class InferenceEngine:
    """Request lifecycle + step loop over a packed model."""

    def __init__(self, model: PackedModel, cfg: EngineConfig = EngineConfig()):
        device = check_device(cfg.device)
        if device.type != model.device.type:
            raise ValueError(f"engine device {device} but model "
                             f"'{model.name}' lives on {model.device}")
        self.model = model
        self.cfg = cfg
        mcfg = model.cfg
        self.scheduler = ContinuousScheduler()
        self.metrics = ServeMetrics()
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
        # a uniformly windowed cache is circular: such requests may run
        # longer than the slab
        self._len_bounded = mcfg.window is None

    # ------------------------------------------------------------------ API

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               arrival_step: int = 0, temperature: float = 0.0,
               eos_id: Optional[int] = None) -> Request:
        r = Request(id=-1, prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=max_new_tokens, arrival_step=arrival_step,
                    temperature=temperature, eos_id=eos_id)
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
            for r in admitted:
                self._start(r)
        if self.pool.n_active:
            advanced = self._decode_block()
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
        if not self.cfg.prefill_buckets:
            return s0
        b = self.cfg.bucket_min
        while b < s0:
            b *= 2
        return b if b <= self._bucket_cap else s0

    def _emit(self, r: Request, tok: int, step: int) -> None:
        r.generated.append(tok)
        self.metrics.on_token(r.id, step)
        if len(r.generated) >= r.max_new_tokens \
                or (r.eos_id is not None and tok == r.eos_id):
            r.state = "done"
            self.pool.free(r.slot)
            self._slots[r.slot] = None
            self.metrics.on_finish(r.id, step)

    def _start(self, r: Request) -> None:
        slot = self.pool.alloc()
        s0 = len(r.prompt)
        sp = self._prefill_len(s0)
        tokens = np.zeros((1, sp), np.int32)
        tokens[0, :s0] = r.prompt
        batch = {"tokens": torch.from_numpy(tokens).to(self.backend.device)}
        logits, caches = self.backend.prefill(batch, exact=sp == s0)
        row = logits[:, -1] if sp == s0 else logits[:, s0 - 1]
        self.backend.write_slot(slot, caches)
        r.state, r.slot, r.index = "running", slot, s0
        self._slots[slot] = r
        self.metrics.on_start(r.id, self.step_count)
        tok = self.backend.first_token(row, r.temperature)
        self.metrics.on_host_sync("prefill")     # the one int32 pulled
        eos = -1 if r.eos_id is None else int(r.eos_id)
        rem = 0 if (r.eos_id is not None and tok == r.eos_id) \
            else r.max_new_tokens - 1
        self.backend.install(slot, tok, r.index, r.temperature, eos, rem)
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

"""Device-resident ineffectual-work ledger for the serving hot path (port of
`repro.serve.ledger`).

The packed formats account for weight-side savings analytically; this
module measures the activation side at run time, on the device, inside the
fused decode, speculative and suffix-prefill steps:

  * per-layer activation zero and near-zero (|x| <= threshold) counts at
    the packed GEMMs' inputs (probe taps in models.transformer,
    models.attention and models.layers);
  * per-group histograms (consecutive `group`-channel groups; bin j counts
    the groups with exactly j near-zero channels);
  * dead k-blocks at the configured block geometry: activation rows whose
    `k_block` consecutive channels are all near-zero, what an
    activation-skipping GEMM at that geometry would skip;
  * effective against dense FLOPs and bytes per probed GEMM.

A probe adds one fixed-width f32 row per tap into its layer's row of an
`(n_layers, width)` buffer that the backend allocates once and the steps
accumulate in place across the K micro-steps (on the card inside the
dispatch's CUDA graph, one `ledger_probe` launch a tap; on the CPU the
plain version). The backend copies the buffer out in the dispatch's one
existing host copy, beside the token block, so the ledger adds no host
sync. Counters are exact in f32 up to 2**24; the backend zeroes the buffer
in place once any cell reaches 2**23, and `LedgerSink` keeps the running
float64 totals on the host.

The models take `probe=None` (no probe work when absent); the engine wires
`NULL_LEDGER` when `EngineConfig.ledger` is None, a no-op singleton whose
hot-path calls allocate nothing. With tracing on, the sink also hands
each dispatch's fractions to the tracer (`ledger_dispatch` events, the
Chrome counter tracks of serve.trace).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ledger_probe import (C_BYTES_DENSE, C_BYTES_EFF,
                                              C_DEAD_KB, C_ELEMS,
                                              C_FLOPS_DENSE, C_FLOPS_EFF,
                                              C_GROUPS, C_HIST, C_KBLOCKS,
                                              C_NEAR, C_ZEROS, N_FIXED,
                                              ledger_row_ref)

__all__ = ["C_BYTES_DENSE", "C_BYTES_EFF", "C_DEAD_KB", "C_ELEMS",
           "C_FLOPS_DENSE", "C_FLOPS_EFF", "C_GROUPS", "C_HIST", "C_KBLOCKS",
           "C_NEAR", "C_ZEROS", "N_FIXED", "LedgerConfig", "LedgerProbe",
           "LedgerSink", "NULL_LEDGER", "NullLedger", "hist_checksum"]


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """Knobs of the ineffectual-work probes.

    threshold: |x| <= threshold counts as near-zero (0.0 = exact zeros
    only, the setting for ReLU-family archs). group: channels per
    histogram group. k_block: the contraction block the dead-block
    accounting assumes. quality_every: shadow-run every Nth full-prefill
    admission through tier 0 (0 = never).
    """

    threshold: float = 0.0
    group: int = 8
    k_block: int = 32
    quality_every: int = 0

    @property
    def width(self) -> int:
        return N_FIXED + self.group + 1


def hist_checksum(mat: np.ndarray, group: int) -> float:
    """Order-sensitive scalar over the per-layer histograms: equality of
    this one number stands for bit-equality of the histogram matrix."""
    mat = np.asarray(mat, np.float64)
    h = mat[:, C_HIST:C_HIST + group + 1]
    weights = np.arange(1, group + 2, dtype=np.float64)
    return float((h * weights[None, :]).sum())


class LedgerProbe:
    """The taps' target during one step: the models call `tap(x, n_out)`
    around their packed GEMMs, and `models.transformer.forward` sets
    `layer` before each layer, so every tap adds its row into `out[layer]`
    (the step's (n_layers, width) f32 buffer, in place): the
    `ledger_probe` kernel on the card, `measure` on the CPU. Layers are
    numbered in model order whatever order they run in (gemma2's local
    layers first, jamba's eight scan slots in turn)."""

    def __init__(self, cfg: LedgerConfig, out: torch.Tensor):
        if tuple(out.shape[1:]) != (cfg.width,):
            raise ValueError(f"ledger buffer {tuple(out.shape)}: rows of "
                             f"width {cfg.width} expected")
        self.cfg = cfg
        self.out = out
        self.layer = 0

    def measure(self, x: torch.Tensor, n_out: int) -> torch.Tensor:
        """One probe row (cfg.width,) f32 for activation x (..., d) feeding
        a GEMM of fan-out n_out: the plain version of the probe kernel."""
        cfg = self.cfg
        return ledger_row_ref(x, n_out, threshold=cfg.threshold,
                              group=cfg.group, k_block=cfg.k_block)

    def tap(self, x: torch.Tensor, n_out: int) -> None:
        cfg = self.cfg
        ops.ledger_probe(x, n_out, self.layer_row(), threshold=cfg.threshold,
                         group=cfg.group, k_block=cfg.k_block)

    def layer_row(self) -> torch.Tensor:
        """The (width,) row the current layer's taps add into."""
        return self.out[self.layer]


class NullLedger:
    """No-op ledger sink: the engine calls these once a dispatch when the
    ledger is off, so they are fixed-arity and allocate nothing."""

    enabled = False
    total = None

    def on_drain(self, cum, step):
        return None

    def rebase(self):
        return None

    def summary(self):
        return {}


NULL_LEDGER = NullLedger()


class LedgerSink(NullLedger):
    """Host-side accumulator behind the per-dispatch drain.

    `on_drain(cum, step)` takes the CUMULATIVE matrix copied out in the
    dispatch's one host copy, forms the delta against the previous
    snapshot, folds it into float64 running totals and passes it to
    `ServeMetrics.on_ledger` and the tracer's `ledger_dispatch` hook.
    `rebase()` resets the snapshot when the backend zeroes the device
    buffer."""

    enabled = True

    def __init__(self, cfg: LedgerConfig, n_layers: int, *, metrics=None,
                 tracer=None):
        self.cfg, self.n_layers = cfg, n_layers
        self.metrics, self.tracer = metrics, tracer
        shape = (n_layers, cfg.width)
        self._prev = np.zeros(shape, np.float64)
        self.total = np.zeros(shape, np.float64)

    def on_drain(self, cum, step):
        if cum is None:
            return None
        cum = np.asarray(cum, np.float64)
        delta = cum - self._prev
        self._prev = cum
        self.total = self.total + delta
        t = delta.sum(axis=0)
        if self.metrics is not None:
            self.metrics.on_ledger(
                elems=t[C_ELEMS], zeros=t[C_ZEROS], near=t[C_NEAR],
                groups=t[C_GROUPS], kblocks=t[C_KBLOCKS],
                dead_kblocks=t[C_DEAD_KB],
                flops_dense=t[C_FLOPS_DENSE], flops_eff=t[C_FLOPS_EFF],
                bytes_dense=t[C_BYTES_DENSE], bytes_eff=t[C_BYTES_EFF])
        if self.tracer is not None:
            elems = max(t[C_ELEMS], 1.0)
            kb = max(t[C_KBLOCKS], 1.0)
            fd = max(t[C_FLOPS_DENSE], 1.0)
            self.tracer.ledger_dispatch(
                step, t[C_ZEROS] / elems, t[C_NEAR] / elems,
                t[C_DEAD_KB] / kb, t[C_FLOPS_EFF] / fd,
                t[C_FLOPS_DENSE], t[C_FLOPS_EFF])
        return delta

    def rebase(self):
        self._prev = np.zeros_like(self._prev)

    def summary(self) -> Dict[str, Any]:
        """The running totals: per-layer fractions, the histogram matrix
        and its checksum."""
        tot = self.total
        elems = np.maximum(tot[:, C_ELEMS], 1.0)
        kb = np.maximum(tot[:, C_KBLOCKS], 1.0)
        return {
            "n_layers": self.n_layers,
            "act_probe_elems": float(tot[:, C_ELEMS].sum()),
            "act_zeros": float(tot[:, C_ZEROS].sum()),
            "act_near_zeros": float(tot[:, C_NEAR].sum()),
            "act_kblocks": float(tot[:, C_KBLOCKS].sum()),
            "act_dead_kblocks": float(tot[:, C_DEAD_KB].sum()),
            "flops_dense": float(tot[:, C_FLOPS_DENSE].sum()),
            "flops_effective": float(tot[:, C_FLOPS_EFF].sum()),
            "bytes_dense": float(tot[:, C_BYTES_DENSE].sum()),
            "bytes_effective": float(tot[:, C_BYTES_EFF].sum()),
            "zero_fraction_by_layer": (tot[:, C_ZEROS] / elems).tolist(),
            "dead_kblock_fraction_by_layer":
                (tot[:, C_DEAD_KB] / kb).tolist(),
            "hist": tot[:, C_HIST:].tolist(),
            "act_hist_checksum": hist_checksum(tot, self.cfg.group),
        }

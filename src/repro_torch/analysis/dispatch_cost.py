"""Dispatch-level cost analysis of one call: the port's counterpart of
`repro.analysis.hlo`.

The JAX package compiles a step and parses its post-SPMD HLO text,
multiplying every computation's cost through the loop nest. The port has
no HLO: its steps are eager PyTorch. So this module counts one call
under a `TorchDispatchMode`, op by op as ATen dispatches them, on meta
tensors (the dry-run's: shapes and dtypes, nothing allocated) or real
ones. A Python loop runs its body as many times as it goes round, so the
count is loop-aware by construction.

Cost model, `hlo.py`'s conventions (`src/repro/analysis/hlo.py:1-30`)
applied per ATen op:

  * a matmul or convolution: `torch.utils.flop_counter`'s registry
    (2 x result elements x contraction for mm / bmm / addmm / baddbmm;
    an einsum reaches ATen as bmm);
  * an elementwise op (ATen's `pointwise` tag): its result elements;
    a reduction (the `reduction` tag, and softmax, which XLA lowers as
    reductions and elementwise ops): its operand elements; a
    transcendental (exp, log, tanh, sin, ...): its result elements,
    counted in `transcendentals` as well;
  * bytes: every op's operand bytes plus its result bytes; views,
    aliases, allocations without a write (`empty`) and casts that return
    their input are free; an indexed read counts twice its result (the
    window it touches, hlo.py's slicing rule), an indexed write twice
    its update. Eager PyTorch does not fuse, so against XLA's count,
    where a fusion's internals are free, this over-counts bytes (every
    intermediate of a chain of elementwise ops goes to memory);
  * collectives: every `c10d.*` and `_c10d_functional.*` op, by kind
    (all-reduce / all-gather / reduce-scatter / all-to-all /
    collective-permute / ragged-all-to-all; a broadcast or send / recv
    counts as a collective-permute), how many times it runs and its
    result bytes; wire bytes are 2x the result for an all-reduce (ring
    reduce-scatter + all-gather) and 1x for the rest; a c10d op of
    another kind (not a barrier or a wait) is named in `warnings`;
  * peak live bytes: the most bytes of storage that ops of the call had
    made and that were alive at once (the arguments' own storage left
    out), standing for `memory_analysis().temp_size_in_bytes`.

`analyze(fn, *args)` returns `hlo.analyze`'s keys but the TPU-only
`bytes_tpu_adjusted` and `convert_bytes`; `n_computations` is the number
of ops counted. `breakdown(fn, *args, top)` groups by (op, result MiB) as
hlo's does. `parse_module`, `Instr` and `Computation` read XLA text and
have no counterpart here.
"""

from __future__ import annotations

import collections
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")

# c10d / functional collective op names -> hlo.py's kinds
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
# c10d ops that move no tensor bytes
_NO_TRAFFIC = {"barrier", "monitored_barrier_", "wait_tensor"}

_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "pow", "sqrt", "rsqrt", "sin", "cos", "tan", "atan2", "erf",
    "erfc", "erfinv", "silu", "gelu", "softplus", "logit", "reciprocal",
}

_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data", "logsumexp"}

# indexed reads (the window they touch) and indexed writes (the update)
_WINDOW_READ = {"index", "gather", "index_select", "embedding", "take",
                "_unsafe_index"}
_WINDOW_WRITE = {"index_put", "index_put_", "_index_put_impl_", "scatter",
                 "scatter_", "scatter_add", "scatter_add_", "index_add",
                 "index_add_", "index_copy", "index_copy_", "scatter_reduce",
                 "scatter_reduce_", "masked_scatter_"}

# ops that touch no byte: allocations without a write, metadata, waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "_local_scalar_dense",
         "detach", "alias",
         "lift_fresh", "set_", "resize_", "wait_tensor", "is_same_size",
         "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "dim", "is_nonzero"}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _numel(ts) -> int:
    return sum(t.numel() for t in ts)


def _storage_key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


class CostMode(TorchDispatchMode):
    """Counts every op dispatched inside it (see the module docstring).
    `keep_ops` keeps one row per op (the dry-run's `--save-hlo` trace);
    `register_arguments(tree)` marks storage that is not the call's own
    (the arguments), before the call."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.transc = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.coll = {k: {"count": 0.0, "bytes": 0.0} for k in COLLECTIVES}
        self.by_key: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0.0, 0.0])
        self.ops: Optional[List[Dict[str, Any]]] = [] if keep_ops else None
        self.warnings: List[str] = []
        self._args: set = set()
        self._live: Dict[int, List[int]] = {}   # key -> [nbytes, refs]
        self.live_bytes = 0
        self.peak_bytes = 0

    # --------------------------------------------------------------- memory
    def register_arguments(self, *trees) -> None:
        for t in _tensors(trees):
            k = _storage_key(t)
            if k is not None:
                self._args.add(k)

    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self._live[key]

    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            k = _storage_key(t)
            if k is None or k in self._args:
                continue
            ent = self._live.get(k)
            if ent is None:
                n = t.untyped_storage().nbytes()
                ent = self._live[k] = [n, 0]
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            ent[1] += 1
            weakref.finalize(t, self._release, k)

    # ---------------------------------------------------------------- count
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns, _, op = func._schema.name.partition("::")
        base = op
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        self._track(outs)
        if ns in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_KIND.get(op)
            if kind is None:
                if op not in _NO_TRAFFIC:
                    self.warnings.append(f"{ns}.{op}: not counted")
                return
            res = _nbytes(outs if ns == "_c10d_functional"
                          else _tensors(args[0]))
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += res
            self._add(op, 0.0, 0.0, res + _nbytes(ins), outs)
            return
        if base in _FREE or func.is_view:
            return
        flops = transc = 0.0
        tags = func.tags
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        elif base in _SOFTMAX:
            n = _numel(ins[:1])
            flops, transc = 5.0 * n, float(n)
        elif torch.Tag.reduction in tags:
            flops = float(_numel(ins[:1]))
        elif torch.Tag.pointwise in tags:
            n = float(_numel(outs))
            flops = n
            if base.rstrip("_") in _TRANSCENDENTAL:
                transc = n
        if base in _WINDOW_READ:
            nbytes = 2.0 * _nbytes(outs)
        elif base in _WINDOW_WRITE:
            upd = ins[2:] if base.startswith("index_put") or \
                base == "_index_put_impl_" else ins[-1:]
            nbytes = 2.0 * _nbytes(upd)
        else:
            nbytes = float(_nbytes(ins) + _nbytes(outs))
        self.transc += transc
        self._add(op, flops, transc, nbytes, outs)

    def _add(self, op, flops, transc, nbytes, outs) -> None:
        self.n_ops += 1
        self.flops += flops
        self.bytes += nbytes
        key = f"{op} {_nbytes(outs) / 2 ** 20:.0f}MiB"
        row = self.by_key[key]
        row[0] += nbytes
        row[1] += flops
        if self.ops is not None:
            self.ops.append({
                "op": op, "shapes": [list(t.shape) for t in outs],
                "dtypes": [str(t.dtype).replace("torch.", "")
                           for t in outs],
                "flops": flops, "bytes": nbytes})

    # --------------------------------------------------------------- report
    def result(self) -> Dict[str, Any]:
        coll = {k: dict(v) for k, v in self.coll.items()}
        wire = 2 * coll["all-reduce"]["bytes"] + sum(
            coll[k]["bytes"] for k in COLLECTIVES if k != "all-reduce")
        return {
            "flops": self.flops,
            "transcendentals": self.transc,
            "bytes": self.bytes,
            "collectives": coll,
            "wire_bytes": wire,
            "n_computations": self.n_ops,
            "peak_bytes": self.peak_bytes,
            "warnings": self.warnings[:20],
        }


def count(fn: Callable, *args, keep_ops: bool = False, **kwargs
          ) -> Tuple[Any, CostMode]:
    """(fn(*args, **kwargs), the CostMode that counted the call)."""
    mode = CostMode(keep_ops=keep_ops)
    mode.register_arguments(args, kwargs)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """One call's cost: `hlo.analyze`'s keys (flops, transcendentals,
    bytes, collectives {kind: {count, bytes}}, wire_bytes,
    n_computations, warnings) and `peak_bytes`, the call's peak live
    bytes beside its arguments."""
    return count(fn, *args, **kwargs)[1].result()


def breakdown(fn: Callable, *args, top: int = 15, **kwargs
              ) -> List[Tuple[str, float, float]]:
    """Top contributors: ('<op> <result MiB>MiB', bytes, flops), most
    bytes first, as `hlo.breakdown` ranks them."""
    mode = count(fn, *args, **kwargs)[1]
    rows = sorted(((k, v[0], v[1]) for k, v in mode.by_key.items()),
                  key=lambda r: -r[1])
    return rows[:top]

"""Packed-model registry: load once, pack once, serve many (port of
`repro.serve.registry`).

`pack_model_params` replaces every projection leaf `{"w"}` named in
`PACKABLE` with a `kratos.PackedLinear`; the model code calls
`kratos.apply` on either, so the packed tree is a drop-in for the dense
one. An MoE layer's routed-expert stacks (raw (E, d, f) arrays, which the
JAX registry leaves unpacked) are frozen once here as the reference runs
them (`models.moe.pack_moe`): a block-sparse tree spec gathers each
expert's kept blocks (from its fake-quant weight when the spec sets bits)
for the expert-batched kernel; any other spec keeps the raw float stack.
They are not counted in `n_packed` or the byte totals, as in the JAX
package; its shared experts pack as any MLP does. Models are keyed by
(arch, KratosSpec, smoke, seed, device, DraftSpec). A `draft_spec`
(serve.speculative) also derives a self-draft from the same dense weights,
part of the artifact's identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.core import kratos as kr
from repro_torch.core import quantize as qz
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import speculative as SP

# the projections that route through kr.apply: attention, MLA's low-rank
# factors, the MLP, Mamba's in/x/out. MLA's q_norm / kv_norm are norms and
# Mamba's dt_proj ({"w", "b"}) stays a plain matmul, as in the JAX package
PACKABLE = frozenset({"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a",
                      "wkv_b", "w_gate", "w_up", "w_down", "in_proj",
                      "x_proj", "out_proj"})


def check_device(device) -> torch.device:
    """The port's entry points run on the card; without one, only an
    explicit device='cpu' runs (through the kernels' plain versions)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _is_packable(node, name: str) -> bool:
    return (isinstance(node, dict) and set(node) == {"w"}
            and name in PACKABLE and node["w"].ndim == 2)


def pack_model_params(params: Dict[str, Any], spec: kr.KratosSpec,
                      ) -> Tuple[Dict[str, Any], int]:
    """Replace packable `{"w"}` leaves with PackedLinear; returns (tree, n)."""
    count = [0]

    def walk(node, name: str):
        if _is_packable(node, name):
            count[0] += 1
            return kr.pack_linear(node, spec)
        if isinstance(node, dict) and "router" in node:
            # an MoE layer: router kept, stacks frozen, shared experts walked
            out = {k: walk(v, k) for k, v in node.items()
                   if k not in M.EXPERT_STACKS}
            return {**out, **M.pack_moe(node, spec)}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(params, ""), count[0]


def _leaves(node, pred):
    if pred(node):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v, pred)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v, pred)


def tree_to(node, device):
    """A parameter tree with every tensor moved to `device`, packed leaves
    (PackedLinear, PackedExperts, QuantizedTensor) included."""
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, (kr.PackedLinear, kr.PackedExperts,
                         qz.QuantizedTensor)):
        return dataclasses.replace(node, **{
            f.name: tree_to(getattr(node, f.name), device)
            for f in dataclasses.fields(node)})
    if isinstance(node, dict):
        return {k: tree_to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_to(v, device) for v in node]
    return node


@dataclasses.dataclass
class PackedModel:
    """A named serving artifact: config + packed parameter tree + stats.

    With `draft_spec` (speculative.DraftSpec) the artifact also carries a
    self-draft: the same dense weights re-packed at the draft's (sparsity,
    bits) point, optionally cut to a leading layer prefix, for the
    speculative decode path."""

    name: str
    cfg: T.ModelConfig
    params: Dict[str, Any]          # tree with PackedLinear leaves
    spec: kr.KratosSpec
    n_packed: int
    packed_bytes: int               # serving bytes of the packed projections
    dense_bytes: int                # bytes of the same dense projections
    device: torch.device
    draft_spec: Any = None          # speculative.DraftSpec or None
    draft_cfg: Optional[T.ModelConfig] = None
    draft_params: Optional[Dict[str, Any]] = None
    draft_packed: int = 0           # projections packed in the draft tree

    @property
    def compression(self) -> float:
        return self.dense_bytes / max(1, self.packed_bytes)

    @property
    def has_draft(self) -> bool:
        return self.draft_params is not None

    def draft_cost_fraction(self) -> float:
        """Analytic draft/target FLOPs-per-token ratio (1.0 without a
        draft)."""
        if not self.has_draft:
            return 1.0
        return SP.draft_cost_fraction(self.cfg, self.draft_cfg)


class ModelRegistry:
    """Named store of packed models, keyed by (arch, KratosSpec)."""

    def __init__(self) -> None:
        self._models: Dict[Tuple, PackedModel] = {}
        self._by_name: Dict[str, PackedModel] = {}

    def load(self, arch: str, spec: Optional[kr.KratosSpec] = None, *,
             params: Optional[Dict[str, Any]] = None, seed: int = 0,
             name: Optional[str] = None, smoke: bool = True,
             device="cuda", draft_spec=None, tier_specs=None) -> PackedModel:
        """Load (or return the cached) packed model for (arch, spec).

        params: dense parameter tree (e.g. from checkpoint.convert); freshly
        initialized from `seed` when omitted. smoke=True uses the reduced
        config. device: where the model lives and runs ('cuda' by default).
        draft_spec (speculative.DraftSpec): also derive a self-draft from
        the same dense weights, which `EngineConfig.speculate` requires; it
        joins the cache key and the default name (`+draft[<tag>]`).
        """
        if tier_specs:
            raise NotImplementedError("QoS tier ladders are not ported yet "
                                      "(ROADMAP.md queue 1, item 8)")
        device = check_device(device)
        cfg = (C.get_smoke if smoke else C.get_config)(arch)
        spec = cfg.kratos if spec is None else spec
        cfg = dataclasses.replace(cfg, kratos=spec)
        key = (arch, spec, smoke, seed, str(device), draft_spec)
        if params is None and key in self._models:
            return self._models[key]
        if params is None:
            params = T.init(cfg, seed=seed, device=device)
        else:
            params = tree_to(params, device)
        draft = {}
        if draft_spec is not None:
            dcfg, dparams, dn = SP.derive_draft(params, cfg, spec, draft_spec)
            draft = dict(draft_spec=draft_spec, draft_cfg=dcfg,
                         draft_params=dparams, draft_packed=dn)
        packed, n_packed = pack_model_params(params, spec)
        linears = list(_leaves(packed, lambda n: isinstance(n, kr.PackedLinear)))
        itemsize = torch.empty((), dtype=cfg.pdtype()).element_size()
        dense_bytes = sum(pl.n_in * pl.n_out for pl in linears) * itemsize
        packed_bytes = sum(pl.packed_bytes for pl in linears)
        tag = kr.spec_tag(spec)
        if draft_spec is not None:
            tag += f"+draft[{draft_spec.tag}]"
        default_name = (f"{arch}@{tag}"
                        + ("" if smoke else "-full")
                        + (f"#s{seed}" if seed else ""))
        model = PackedModel(name=name or default_name, cfg=cfg, params=packed,
                            spec=spec, n_packed=n_packed,
                            packed_bytes=packed_bytes,
                            dense_bytes=dense_bytes, device=device, **draft)
        self._models[key] = model
        self._by_name[model.name] = model
        return model

    def get(self, name: str) -> PackedModel:
        if name not in self._by_name:
            raise KeyError(f"no model '{name}'; loaded: {sorted(self._by_name)}")
        return self._by_name[name]

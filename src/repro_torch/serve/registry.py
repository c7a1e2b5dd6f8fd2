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
package; its shared experts pack as any MLP does. `load` packs leaf by
leaf and lets each float leaf go as soon as its packed form exists, so a
model whose dense tree fills most of the card (jamba at 8 layers, 53 GB
in f32) packs beside it. Models are keyed by (arch, KratosSpec, smoke,
seed, device, DraftSpec, tier ladder, depth cut). A `draft_spec`
(serve.speculative) also derives a self-draft from the same dense weights,
and `tier_specs` (serve.qos) a ladder of cheaper (sparsity, bits) tiers of
them, each part of the artifact's identity. The tiers pack off the dense
tree before the target's pack consumes it, so the load holds the dense
tree, every tier and the target's growing pack at once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.checkpoint import convert as CV
from repro_torch.core import kratos as kr
from repro_torch.core import quantize as qz
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import qos as Q
from repro_torch.serve import speculative as SP

# the projections that route through kr.apply: attention (the encoder's and
# the cross-attention's among them), MLA's low-rank factors, the MLP,
# Mamba's in/x/out. MLA's q_norm / kv_norm are norms and Mamba's dt_proj
# ({"w", "b"}) stays a plain matmul, as in the JAX package
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


def pack_model_params(params: Dict[str, Any], spec: kr.KratosSpec, *,
                      consume: bool = False) -> Tuple[Dict[str, Any], int]:
    """Replace packable `{"w"}` leaves with PackedLinear; returns (tree, n).

    consume: empty each packed leaf's dict in `params` (and take each
    routed stack out of its MoE layer) as soon as its packed form exists,
    so a float weight nothing else holds frees before the next leaf packs;
    `params` is left without its projection weights."""
    count = [0]

    def walk(node, name: str):
        if _is_packable(node, name):
            count[0] += 1
            out = kr.pack_linear(node, spec)
            if consume:
                node.clear()
            return out
        if isinstance(node, dict) and "router" in node:
            # an MoE layer: router kept, stacks frozen, shared experts walked
            out = {k: walk(v, k) for k, v in node.items()
                   if k not in M.EXPERT_STACKS}
            return {**out, **M.pack_moe(node, spec, consume=consume)}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(params, ""), count[0]


def reference_packed(packed: Dict[str, Any], cfg: T.ModelConfig) -> int:
    """Packed projections counted as the JAX package's layer-stacked tree
    holds them: one per projection of a prelude layer and of a scan slot
    (the slot's layers are rows of one leaf), and one per projection of
    the stacked encoder (`checkpoint.convert.reference_layers`)."""
    heads = [packed["layers"][i] for i in CV.reference_layers(cfg)]
    heads += packed.get("enc_layers", [])[:1]
    return sum(1 for h in heads
               for _ in _leaves(h, lambda n: isinstance(n, kr.PackedLinear)))


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
    speculative decode path.

    With `tier_specs` (serve.qos) it carries a QoS ladder: the same dense
    weights packed at 1-2 cheaper (sparsity, bits) points, full depth,
    same cache. Tier 0 is `params`; `tier_params[i]` backs engine tier
    i + 1."""

    name: str
    cfg: T.ModelConfig
    params: Dict[str, Any]          # tree with PackedLinear leaves
    spec: kr.KratosSpec
    n_packed: int                   # as the JAX package counts (reference_packed)
    packed_bytes: int               # serving bytes of the packed projections
    dense_bytes: int                # bytes of the same dense projections
    device: torch.device
    draft_spec: Any = None          # speculative.DraftSpec or None
    draft_cfg: Optional[T.ModelConfig] = None
    draft_params: Optional[Dict[str, Any]] = None
    draft_packed: int = 0           # projections packed in the draft tree
    tier_specs: Tuple = ()          # QoS ladder (DraftSpec per cheap tier)
    tier_params: Tuple = ()         # matching packed trees (same cache)

    @property
    def compression(self) -> float:
        return self.dense_bytes / max(1, self.packed_bytes)

    @property
    def has_draft(self) -> bool:
        return self.draft_params is not None

    @property
    def n_tiers(self) -> int:
        """Resident quality tiers: the full-quality tree and the ladder."""
        return 1 + len(self.tier_params)

    def tier_tree(self, tier: int) -> Dict[str, Any]:
        """The packed tree behind engine tier `tier` (0 = full quality)."""
        return self.params if tier == 0 else self.tier_params[tier - 1]

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
             device="cuda", draft_spec=None, tier_specs=None,
             n_layers: Optional[int] = None) -> PackedModel:
        """Load (or return the cached) packed model for (arch, spec).

        params: dense parameter tree (e.g. from checkpoint.convert); freshly
        initialized from `seed` when omitted. smoke=True uses the reduced
        config. device: where the model lives and runs ('cuda' by default).
        draft_spec (speculative.DraftSpec): also derive a self-draft from
        the same dense weights, which `EngineConfig.speculate` requires; it
        joins the cache key and the default name (`+draft[<tag>]`).
        tier_specs (tuple of DraftSpec, cheapest last): also keep a QoS
        ladder resident, the same dense weights packed at each cheaper
        (sparsity, bits) point (`qos.check_tier_spec`), which
        `EngineConfig.qos` requires; it joins the key and the name
        (`+tiers[<tag>,...]`).
        n_layers: cut the config to its first n_layers layers (a depth cut
        of the published model; it joins the key and the name).
        """
        tier_specs = tuple(Q.check_tier_spec(ts) for ts in tier_specs or ())
        device = check_device(device)
        cfg = (C.get_smoke if smoke else C.get_config)(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        spec = cfg.kratos if spec is None else spec
        cfg = dataclasses.replace(cfg, kratos=spec)
        key = (arch, spec, smoke, seed, str(device), draft_spec, tier_specs,
               n_layers)
        if params is None and key in self._models:
            return self._models[key]
        if params is None:
            params = T.init(cfg, seed=seed, device=device)
        else:
            params = tree_to(params, device)
            if cfg.enc_dec and "pos_table" not in params:
                # no checkpoint carries the sinusoidal position table
                params["pos_table"] = T.position_table(cfg.d_model, device)
        draft = {}
        if draft_spec is not None:
            dcfg, dparams, _ = SP.derive_draft(params, cfg, spec, draft_spec)
            draft = dict(draft_spec=draft_spec, draft_cfg=dcfg,
                         draft_params=dparams,
                         draft_packed=reference_packed(dparams, dcfg))
        # every tier packs off the DENSE leaves, so the ladder packs before
        # the target's pack empties the tree
        tier_params = tuple(
            pack_model_params(params, ts.kratos_spec(spec))[0]
            for ts in tier_specs)
        # `params` is this call's own tree (fresh, or tree_to's new
        # containers): packing may empty it leaf by leaf
        packed, _ = pack_model_params(params, spec, consume=True)
        del params
        linears = list(_leaves(packed, lambda n: isinstance(n, kr.PackedLinear)))
        itemsize = torch.empty((), dtype=cfg.pdtype()).element_size()
        dense_bytes = sum(pl.n_in * pl.n_out for pl in linears) * itemsize
        packed_bytes = sum(pl.packed_bytes for pl in linears)
        tag = kr.spec_tag(spec)
        if draft_spec is not None:
            tag += f"+draft[{draft_spec.tag}]"
        if tier_specs:
            tag += "+tiers[" + ",".join(ts.tag for ts in tier_specs) + "]"
        default_name = (f"{arch}@{tag}"
                        + ("" if smoke else "-full")
                        + (f"-{n_layers}L" if n_layers is not None else "")
                        + (f"#s{seed}" if seed else ""))
        model = PackedModel(name=name or default_name, cfg=cfg, params=packed,
                            spec=spec, n_packed=reference_packed(packed, cfg),
                            packed_bytes=packed_bytes,
                            dense_bytes=dense_bytes, device=device,
                            tier_specs=tier_specs, tier_params=tier_params,
                            **draft)
        self._models[key] = model
        self._by_name[model.name] = model
        return model

    def get(self, name: str) -> PackedModel:
        if name not in self._by_name:
            raise KeyError(f"no model '{name}'; loaded: {sorted(self._by_name)}")
        return self._by_name[name]

    def names(self):
        return sorted(self._by_name)

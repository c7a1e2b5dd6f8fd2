"""Speculative decode: the Kratos grid as a self-draft axis (port of
`repro.serve.speculative`).

A self-draft is the target's own dense weights re-packed at a cheaper
(sparsity, bits) point, optionally cut to its first `keep_layers` layers.
The draft proposes K tokens, the target verifies the whole block in one
dispatch, and per-slot accept/reject commits the longest agreeing prefix
plus one target-sampled bonus token. Greedy speculative decode is
token-identical to plain decode for any draft; sampled rows use the
rejection-sampling correction, so the committed stream follows the target.

This module holds the registry and policy side: `DraftSpec`,
`draft_config`, `truncate_layers`, `derive_draft`, `draft_cost_fraction`
and `check_supported`. The fused propose-then-verify step is
`distributed.steps.make_speculative_decode_step`; the slab plumbing is in
`serve.backend`, the `speculate=K` knobs in `serve.engine` and
`serve.scheduler.Request`.

The draft slab is a second `CachePool` with the target's slot assignment
and the same per-slot index clock (`state["index"]`): at every dispatch
boundary both caches hold exactly the committed prefix.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import kratos as kr
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """How to derive a self-draft artifact from the target weights.

    bits / sparsity / impl / act_bits apply to the draft's repack only;
    bk / bn default to the target spec's block grid (None = inherit).
    keep_layers keeps the first `keep_layers` layers (None = full depth);
    the draft shares the target's embedding, final norm and head, so the
    logit spaces align. cache_dtype overrides the draft slab's dtype (None
    = the engine's cache dtype)."""

    bits: Optional[int] = 8
    sparsity: float = 0.0
    impl: str = "tree"
    act_bits: Optional[int] = None
    bk: Optional[int] = None
    bn: Optional[int] = None
    keep_layers: Optional[int] = None
    cache_dtype: Optional[str] = None

    def __post_init__(self):
        if self.keep_layers is not None and self.keep_layers < 1:
            raise ValueError(f"keep_layers must be >= 1, got "
                             f"{self.keep_layers}")

    @classmethod
    def from_args(cls, bits: int, sparsity: float,
                  keep_layers: int) -> "DraftSpec":
        """The CLI policy of the JAX package: bits=0 means native
        precision, any sparsity uses the 8x8 block grid every smoke d_model
        divides, keep_layers=0 keeps full depth."""
        return cls(bits=bits or None, sparsity=sparsity,
                   bk=8 if sparsity else None, bn=8 if sparsity else None,
                   keep_layers=keep_layers or None)

    def kratos_spec(self, base: kr.KratosSpec) -> kr.KratosSpec:
        """The KratosSpec the draft packs with (block grid from `base`)."""
        return dataclasses.replace(
            base, bits=self.bits, sparsity=self.sparsity, impl=self.impl,
            act_bits=self.act_bits,
            bk=self.bk if self.bk is not None else base.bk,
            bn=self.bn if self.bn is not None else base.bn)

    @property
    def tag(self) -> str:
        """Registry-name fragment: every field that changes the artifact,
        in the JAX package's format."""
        t = kr.spec_tag(kr.KratosSpec(sparsity=self.sparsity, bits=self.bits,
                                      impl=self.impl, act_bits=self.act_bits))
        if self.bk is not None or self.bn is not None:
            t += f"-b{self.bk or 'i'}x{self.bn or 'i'}"   # 'i' = inherited
        if self.keep_layers is not None:
            t += f"-l{self.keep_layers}"
        if self.cache_dtype:
            t += f"-c{self.cache_dtype}"
        return t


def draft_config(cfg: T.ModelConfig, dspec: DraftSpec,
                 base_spec: kr.KratosSpec) -> T.ModelConfig:
    """The draft's ModelConfig: the target arch at the draft's Kratos
    point, optionally cut to its first keep_layers layers (every ported
    arch repeats one layer kind, so any prefix is a whole model)."""
    n = cfg.n_layers
    if dspec.keep_layers is not None:
        n = dspec.keep_layers
        if n > cfg.n_layers:
            raise ValueError(f"keep_layers={n} > n_layers={cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=n,
                               kratos=dspec.kratos_spec(base_spec))


def truncate_layers(params: Dict[str, Any],
                    draft_cfg: T.ModelConfig) -> Dict[str, Any]:
    """Keep the first draft_cfg.n_layers entries of the per-layer list (the
    same layers as the JAX package's slice of each stacked slot). The
    embedding, final norm and head are the target's own tensors."""
    return dict(params, layers=params["layers"][:draft_cfg.n_layers])


def derive_draft(params: Dict[str, Any], cfg: T.ModelConfig,
                 target_spec: kr.KratosSpec, dspec: DraftSpec,
                 ) -> Tuple[T.ModelConfig, Dict[str, Any], int]:
    """(draft config, packed draft tree, n packed) from the DENSE target
    params: the draft packs the same weights the target packs from, at the
    draft's point of the (sparsity, precision) grid."""
    from repro_torch.serve.registry import pack_model_params   # cycle
    refuse_experts(cfg)
    dcfg = draft_config(cfg, dspec, target_spec)
    dparams = params
    if dcfg.n_layers < cfg.n_layers:
        dparams = truncate_layers(params, dcfg)
    packed, n = pack_model_params(dparams, dcfg.kratos)
    if n == 0:
        raise ValueError("draft spec packs no projections: a draft that "
                         "serves dense training weights is not a draft")
    return dcfg, packed, n


def draft_cost_fraction(cfg: T.ModelConfig,
                        draft_cfg: T.ModelConfig) -> float:
    """Analytic draft/target FLOPs per token (the metrics'
    `draft_verify_flop_ratio`): params (all active: the ported archs have no
    experts) scaled by the 'tree' impl's (1 - sparsity). Quantization
    changes bytes, not FLOPs."""
    def cost(c: T.ModelConfig) -> float:
        s = c.kratos
        frac = (1.0 - s.sparsity) if (s.sparsity and s.impl == "tree") else 1.0
        return 2.0 * c.param_count() * frac
    return cost(draft_cfg) / max(1.0, cost(cfg))


def refuse_experts(cfg: T.ModelConfig) -> None:
    """Speculative decode of a mixture-of-experts arch is not ported yet."""
    if cfg.n_experts:
        raise NotImplementedError(
            f"speculative decode of the MoE arch '{cfg.name}' is not ported "
            "yet (ROADMAP.md queue 1, item 8)")


def check_supported(cfg: T.ModelConfig, cache_len: int) -> None:
    """Refuse archs whose cache cannot roll back.

    A rejected draft suffix costs a per-slot index rewind: stale positions
    are masked by the validity clocks and overwritten later. A CIRCULAR
    sliding-window cache (window < allocated positions) breaks that: the
    speculative writes land on rows that still hold live history, and
    rewinding the clock cannot restore what they evicted."""
    if cfg.window is not None and cfg.window < cache_len:
        raise ValueError(
            f"speculative decode unsupported: sliding-window cache "
            f"(window={cfg.window} < {cache_len} positions) is circular; "
            f"rolling back rejected draft tokens would need the history "
            f"their writes evicted. Serve with max_len + K <= window, or "
            f"without speculation.")

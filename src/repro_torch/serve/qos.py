"""QoS tiers: the Kratos (sparsity, bits) grid as a live degradation ladder
(port of `repro.serve.qos`).

The registry keeps 2-3 packed tiers of the same dense weights resident
(`ModelRegistry.load(..., tier_specs=...)`), and the engine moves its
decode onto a cheaper tier under measured load instead of saturating.

  * tier 0 is the model's own `KratosSpec`: full quality;
  * tier i >= 1 is `tier_specs[i-1]` applied to the SAME dense weights, a
    cheaper (sparsity, bits) point at full depth with the same cache
    layout.

A tier spec keeps full depth (`keep_layers=None`) and the engine's cache
dtype (`cache_dtype=None`), so every tier shares one cache: a swap changes
only the parameters the decode step reads. On the card each tier's
dispatch is its own CUDA graph, captured at build, and a swap selects one
(serve.backend); the pools and the loop state stay put, and every
in-flight stream continues from its exact position.

`QoSController` demotes after `hysteresis` CONSECUTIVE steps with the
waiting deque at or above `demote_depth` (or the page pool at or above
`page_pressure` full), and promotes one tier after `hysteresis`
consecutive steps at or below `promote_depth`. The dead band between the
watermarks resets both streaks, so a load oscillating inside it never
flaps the tier. One observation a step keeps the controller on the
deterministic engine-step clock.

`Request.tier` records the cheapest tier a request decoded on;
ServeMetrics counts `tier_demotions` and `tier_promotions`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.serve.speculative import DraftSpec


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Degradation policy, carried by `EngineConfig.qos` (None = the
    engine never leaves tier 0)."""

    demote_depth: int = 8        # waiting-deque watermark to degrade at
    promote_depth: int = 1       # ... to recover at (must be < demote)
    hysteresis: int = 4          # consecutive steps past a watermark
    page_pressure: float = 0.95  # page-pool fullness that also demotes

    def __post_init__(self):
        if self.promote_depth >= self.demote_depth:
            raise ValueError(
                f"promote_depth ({self.promote_depth}) must be below "
                f"demote_depth ({self.demote_depth}): equal watermarks "
                "would flap the tier every hysteresis window")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got "
                             f"{self.hysteresis}")


class QoSController:
    """Hysteresis ladder over `n_tiers` packed tiers (tier 0 = best)."""

    def __init__(self, cfg: QoSConfig, n_tiers: int) -> None:
        if n_tiers < 2:
            raise ValueError(f"QoS needs >= 2 resident tiers to ladder "
                             f"between, got {n_tiers} (load the model with "
                             "registry.load(..., tier_specs=...))")
        self.cfg = cfg
        self.n_tiers = n_tiers
        self.tier = 0
        self._over = 0           # consecutive observations above demote
        self._under = 0          # consecutive observations below promote

    def observe(self, queue_depth: int, page_frac: float = 0.0) -> int:
        """One engine step's load signal -> the tier the engine should
        run. The same (depth, page_frac) sequence gives the same path."""
        over = (queue_depth >= self.cfg.demote_depth
                or page_frac >= self.cfg.page_pressure)
        under = (queue_depth <= self.cfg.promote_depth
                 and page_frac < self.cfg.page_pressure)
        if over:
            self._over += 1
            self._under = 0
            if self._over >= self.cfg.hysteresis \
                    and self.tier < self.n_tiers - 1:
                self.tier += 1
                self._over = 0
        elif under:
            self._under += 1
            self._over = 0
            if self._under >= self.cfg.hysteresis and self.tier > 0:
                self.tier -= 1
                self._under = 0
        else:
            self._over = self._under = 0        # dead band: no streaks
        return self.tier


def check_tier_spec(ts: DraftSpec) -> DraftSpec:
    """Refuse a tier spec that would change the cache a resident request's
    history lives in (a cut depth or another cache dtype): a swap would
    corrupt every in-flight stream."""
    if ts.keep_layers is not None:
        raise ValueError(
            f"tier spec {ts.tag}: keep_layers is a draft-only axis: a "
            "truncated tier has a different cache, so an in-place tier "
            "swap would orphan every resident request's KV history")
    if ts.cache_dtype is not None:
        raise ValueError(
            f"tier spec {ts.tag}: cache_dtype must inherit the engine's "
            "(None): tiers share one live KV cache across swaps")
    return ts


def parse_tiers(arg: str) -> Tuple[DraftSpec, ...]:
    """A tier ladder 'bits:sparsity[,bits:sparsity...]', cheapest last
    ('8:0.5,8:0.75' = two tiers below the full model); bits 0 means native
    precision."""
    tiers = []
    for part in arg.split(","):
        if not part.strip():
            continue
        bits_s, _, sp_s = part.partition(":")
        tiers.append(check_tier_spec(
            DraftSpec.from_args(int(bits_s), float(sp_s or 0.0), 0)))
    if not tiers:
        raise ValueError(f"no tiers in {arg!r}")
    return tuple(tiers)

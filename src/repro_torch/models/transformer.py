"""Dense GQA decoder (the dense half of `repro.models.transformer`).

Parameters are a plain dict with a per-layer list in place of the JAX
package's stacked `blocks` consumed by `lax.scan`:

    {"embed": {"emb": (vocab, d)}, "final_norm": {"scale"},
     "head": {"w": (d, vocab)}            (untied embeddings only),
     "layers": [{"pre_norm", "mixer": {wq, wk, wv, wo}, "ffn_norm",
                 "ffn": {w_gate?, w_up, w_down}}, ...]}

Caches are a per-layer list of {"k", "v"} tensors (models.attention).
MoE, MLA, Mamba, encoder-decoder and the gemma2 norms are not ported yet
(ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import kratos as kr
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 128
    vocab: int = 256
    head_dim: int = 0                     # 0 -> d_model // n_heads
    activation: str = "silu"
    gated_mlp: Optional[bool] = None      # None -> infer from activation
    norm: str = "rmsnorm"                 # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    rmsnorm_plus_one: bool = False
    tie_embeddings: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    qk_norm: bool = False
    window: Optional[int] = None          # sliding window on every layer
    kratos: kr.KratosSpec = kr.DENSE
    param_dtype: str = "float32"
    dtype: str = "float32"                # activation dtype

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def gated(self) -> bool:
        return self.gated_mlp if self.gated_mlp is not None \
            else self.activation in ("silu", "gelu", "gelu_tanh")

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def layer_kind(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    """What lives at layer i; every layer of a dense decoder is alike."""
    return {"mixer": "attn", "window": cfg.window, "ffn": "mlp"}


def attn_cfg_for(cfg: ModelConfig, kind: Dict) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.dh, rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
        causal=True, window=kind["window"], softcap=cfg.attn_softcap,
        qk_norm=cfg.qk_norm, attn_scale=cfg.attn_scale)


def _norm_params(cfg: ModelConfig, device) -> Dict:
    p = {"scale": torch.ones(cfg.d_model, dtype=cfg.pdtype(), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=cfg.pdtype(), device=device)
    return p


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return L.layernorm(p, x, cfg.norm_eps)
    return L.rmsnorm(p, x, cfg.norm_eps, scale_plus_one=cfg.rmsnorm_plus_one)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded torch.Generator on `device`. The
    numbers differ from the JAX package's init; parity tests carry JAX
    weights across with `checkpoint.convert` instead."""
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device, dtype=cfg.pdtype())
    layers = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        layers.append({
            "pre_norm": _norm_params(cfg, device),
            "mixer": A.gqa_init(attn_cfg_for(cfg, kind), cfg.kratos, **kw),
            "ffn_norm": _norm_params(cfg, device),
            "ffn": L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.gated,
                              spec=cfg.kratos, **kw),
        })
    params = {
        "embed": {"emb": torch.randn((cfg.vocab, cfg.d_model), **kw) * 0.02},
        "final_norm": _norm_params(cfg, device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = kr.init(cfg.d_model, cfg.vocab, kr.DENSE, **kw)
    return params


def _layer_apply(p: Dict, x, cfg: ModelConfig, kind: Dict, *, positions,
                 cache, index):
    h = _norm(cfg, p["pre_norm"], x)
    h, cache = A.gqa_apply(p["mixer"], h, attn_cfg_for(cfg, kind),
                           positions=positions, cache=cache, index=index)
    x = x + h * cfg.residual_scale
    h = _norm(cfg, p["ffn_norm"], x)
    h = L.mlp_apply(p["ffn"], h, activation=cfg.activation)
    x = x + h * cfg.residual_scale
    return x.to(cfg.adtype()), cache


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[List[Dict]] = None, index=None,
            last_only: bool = False) -> Tuple[torch.Tensor, Optional[List]]:
    """Decoder forward. tokens: (B, S) int. Returns (f32 logits, caches).

    caches: per-layer list from `make_caches` or None. index None runs the
    full sequence (filling `caches` when given: prefill); a 0-d or (B,)
    int32 tensor decodes at that position, writing the caches in place.
    last_only: logits for the final position only."""
    x = L.embed(params["embed"], tokens, scale=cfg.emb_scale).to(cfg.adtype())
    positions = None if index is None else \
        A._positions_for(index, x.shape[1], x.device)
    for li, lp in enumerate(params["layers"]):
        c = caches[li] if caches is not None else None
        x, _ = _layer_apply(lp, x, cfg, layer_kind(cfg, li),
                            positions=positions, cache=c, index=index)
    if last_only:
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, params.get("head"),
                       softcap=cfg.logit_softcap)
    return logits, caches


def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.float32, device="cuda") -> List[Dict]:
    return [A.make_gqa_cache(attn_cfg_for(cfg, layer_kind(cfg, i)), batch,
                             max_len, dtype, device)
            for i in range(cfg.n_layers)]


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor) -> torch.Tensor:
    """Per-row Gumbel-max sampling (argmax when temperature <= 0), on the
    logits' device. logits (B, vocab); temperature (B,) f32. Returns (B,)
    int32. The noise comes from `generator`, so sampled tokens differ from
    the JAX package's; greedy rows match it."""
    logits = logits.float()
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    safe_t = temperature.clamp(min=1e-6)[:, None]
    scores = torch.where((temperature > 0.0)[:, None], logits / safe_t + g,
                         logits)
    return torch.argmax(scores, dim=-1).to(torch.int32)

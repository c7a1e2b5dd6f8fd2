"""Dense GQA, MLA, mixture-of-experts and pure Mamba-1 decoders (the
dense, MLA, MoE and `is_ssm` parts of `repro.models.transformer`).

Parameters are a plain dict with a per-layer list in place of the JAX
package's stacked `blocks` consumed by `lax.scan`:

    {"embed": {"emb": (vocab, d)}, "final_norm": {"scale"},
     "head": {"w": (d, vocab)}            (untied embeddings only),
     "layers": [{"pre_norm", "post_norm"?, "mixer": {wq, wk, wv, wo},
                 "ffn_norm", "ffn_post_norm"?,
                 "ffn": {w_gate?, w_up, w_down}}, ...]}

gemma2's sandwich norms (`post_norm`, `ffn_post_norm`) normalize the
mixer's and the MLP's output before the residual add; its layers alternate
local (the config's window, layer 0 first) and global (no window). An MLA
model (minicpm3) has {wq_a, q_norm, wq_b | wq, wkv_a, kv_norm, wkv_b, wo}
as its mixer. An `is_ssm` model (falcon-mamba) has a Mamba mixer
(models.ssm) and no FFN in every layer: {"pre_norm", "mixer": {in_proj,
conv_w, ...}}. Caches are a per-layer list of {"k", "v"} tensors (MLA:
{"c_kv", "k_rope"}; models.attention), slab rows or, under a paged pool,
page-major store leaves; a Mamba layer's is {"conv", "ssm"}, always
slot-major. An MoE layer (deepseek; `prelude_layers` dense layers
first) has {"ffn_norm", "ffn": {"router": {"w"}, "w_gate", "w_up",
"w_down" (raw (E, d, f) stacks, or their packed form), "shared"?}}
(models.moe). The jamba hybrid, encoder-decoder and the vision stub are
not ported yet (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import kratos as kr
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


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
    rmsnorm_plus_one: bool = False        # gemma convention
    sandwich_norm: bool = False           # gemma2 pre+post norms
    tie_embeddings: bool = True
    use_rope: bool = True
    rope_theta: float = 10000.0
    emb_scale: float = 1.0
    residual_scale: float = 1.0
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    qk_norm: bool = False
    # windows: `window` applies to every attention layer, unless
    # local_global_period=2 alternates local(window)/global (gemma2,
    # local first)
    window: Optional[int] = None
    local_global_period: Optional[int] = None
    # MLA
    mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE: every layer from `prelude_layers` on with i % moe_period ==
    # moe_offset routes its FFN over experts; the prelude layers are dense
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1
    moe_offset: int = 0
    prelude_layers: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001          # a training term: unused here
    # Mamba (pure SSM: every layer a Mamba-1 mixer without FFN)
    is_ssm: bool = False
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    bcdt_rms: bool = False
    ssm_chunk: int = 256                  # JAX's XLA scan chunk (no use here)
    # the JAX package stacks layers of one pattern slot and runs the slots'
    # stacks in turn; `layer_order` reproduces the order that gives
    scan_period: int = 1
    kratos: kr.KratosSpec = kr.DENSE
    param_dtype: str = "float32"
    dtype: str = "float32"                # activation dtype

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def gated(self) -> bool:
        return self.gated_mlp if self.gated_mlp is not None \
            else self.activation in ("silu", "gelu", "gelu_tanh")

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count, the JAX package's formula for the
        ported families (dense GQA or MLA + MLP or MoE, pure Mamba-1; norms
        are not counted, as there)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = layer_kind(self, i)
            if kind["mixer"] == "attn" and self.mla:
                h, qd = self.n_heads, self.qk_nope_dim + self.qk_rope_dim
                if self.q_lora_rank:
                    total += d * self.q_lora_rank + self.q_lora_rank * h * qd
                else:
                    total += d * h * qd
                total += d * (self.kv_lora_rank + self.qk_rope_dim)
                total += self.kv_lora_rank * h * (self.qk_nope_dim
                                                  + self.v_head_dim)
                total += h * self.v_head_dim * d
            elif kind["mixer"] == "attn":
                total += 2 * d * self.n_heads * self.dh \
                    + 2 * d * self.n_kv_heads * self.dh
            else:
                di, r, st = self.d_inner, max(1, -(-d // 16)), self.d_state
                total += d * 2 * di + self.d_conv * di + di * (r + 2 * st) \
                    + r * di + di * st + di + di * d
            if kind["ffn"] == "moe":
                total += d * self.n_experts                   # router
                total += (self.n_experts + self.n_shared_experts) * 3 * d \
                    * self.d_ff_expert
            elif kind["ffn"] == "mlp":
                total += (3 if self.gated else 2) * d * self.d_ff
        return int(total)


def layer_kind(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    """What lives at layer i: attention + MLP or MoE, or (is_ssm) a Mamba
    mixer without FFN. With local_global_period the attention layer i is
    local (the config's window) when i % period == 0, else global (no
    window). With experts, layer i >= prelude_layers with i % moe_period
    == moe_offset is MoE, the rest dense MLP."""
    if cfg.is_ssm:
        return {"mixer": "mamba", "window": cfg.window, "ffn": "none"}
    window = cfg.window
    if cfg.local_global_period:
        window = cfg.window if i % cfg.local_global_period == 0 else None
    ffn = "mlp"
    if cfg.n_experts and i >= cfg.prelude_layers \
            and i % cfg.moe_period == cfg.moe_offset:
        ffn = "moe"
    return {"mixer": "attn", "window": window, "ffn": ffn}


def layer_order(cfg: ModelConfig) -> List[int]:
    """The order the layers run in, the JAX package's: the prelude layers
    first, then each scan slot's stack in turn, so with scan_period p it
    runs layers n0 + s, n0 + s + p, ... for s = 0 .. p-1 (gemma2: every
    local layer, then every global one). Parameters and caches stay in
    layer order."""
    p, n0 = cfg.scan_period, cfg.prelude_layers
    if (cfg.n_layers - n0) % p:
        raise ValueError(f"n_layers - prelude_layers = {cfg.n_layers - n0} "
                         f"not divisible by scan_period {p}")
    return list(range(n0)) + [n0 + t * p + s for s in range(p)
                              for t in range((cfg.n_layers - n0) // p)]


def attn_cfg_for(cfg: ModelConfig, kind: Dict) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.dh, rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
        causal=True, window=kind["window"], softcap=cfg.attn_softcap,
        qk_norm=cfg.qk_norm, attn_scale=cfg.attn_scale, mla=cfg.mla,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim)


def moe_cfg_for(cfg: ModelConfig) -> M.MoEConfig:
    return M.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert, n_shared=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor, activation=cfg.activation)


def mamba_cfg_for(cfg: ModelConfig) -> S.MambaConfig:
    return S.MambaConfig(
        d_model=cfg.d_model, d_inner=cfg.d_inner, d_state=cfg.d_state,
        d_conv=cfg.d_conv, bcdt_rms=cfg.bcdt_rms)


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
        layer = {"pre_norm": _norm_params(cfg, device)}
        if cfg.sandwich_norm:
            layer["post_norm"] = _norm_params(cfg, device)
        if kind["mixer"] == "mamba":
            layer["mixer"] = S.mamba_init(mamba_cfg_for(cfg), cfg.kratos, **kw)
        else:
            layer["mixer"] = A.attn_init(attn_cfg_for(cfg, kind), cfg.kratos,
                                         **kw)
        if kind["ffn"] == "mlp":
            layer["ffn_norm"] = _norm_params(cfg, device)
            if cfg.sandwich_norm:
                layer["ffn_post_norm"] = _norm_params(cfg, device)
            layer["ffn"] = L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.gated,
                                      spec=cfg.kratos, **kw)
        elif kind["ffn"] == "moe":
            layer["ffn_norm"] = _norm_params(cfg, device)
            layer["ffn"] = M.moe_init(moe_cfg_for(cfg), cfg.kratos, **kw)
        layers.append(layer)
    params = {
        "embed": {"emb": torch.randn((cfg.vocab, cfg.d_model),
                                     **kw).mul_(0.02)},
        "final_norm": _norm_params(cfg, device),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["head"] = kr.init(cfg.d_model, cfg.vocab, kr.DENSE, **kw)
    return params


def _layer_apply(p: Dict, x, cfg: ModelConfig, kind: Dict, *, positions,
                 cache, index, pages):
    h = _norm(cfg, p["pre_norm"], x)
    if kind["mixer"] == "mamba":
        # recurrent state: O(1) per slot and resident, so pages and
        # positions do not reach it
        h, cache = S.mamba_apply(p["mixer"], h, mamba_cfg_for(cfg),
                                 cache=cache, index=index)
    else:
        h, cache = A.attn_apply(p["mixer"], h, attn_cfg_for(cfg, kind),
                                positions=positions, cache=cache,
                                index=index, pages=pages)
    if cfg.sandwich_norm:
        h = _norm(cfg, p["post_norm"], h)
    x = x + h * cfg.residual_scale
    if kind["ffn"] == "moe":
        h = _norm(cfg, p["ffn_norm"], x)
        x = x + M.moe_apply(p["ffn"], h, moe_cfg_for(cfg)) \
            * cfg.residual_scale
    elif kind["ffn"] == "mlp":
        h = _norm(cfg, p["ffn_norm"], x)
        h = L.mlp_apply(p["ffn"], h, activation=cfg.activation)
        if cfg.sandwich_norm:
            h = _norm(cfg, p["ffn_post_norm"], h)
        x = x + h * cfg.residual_scale
    return x.to(cfg.adtype()), cache


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[List[Dict]] = None, index=None,
            pages: Optional[Dict] = None,
            last_only: bool = False) -> Tuple[torch.Tensor, Optional[List]]:
    """Decoder forward. tokens: (B, S) int. Returns (f32 logits, caches).

    caches: per-layer list from `make_caches` (or a paged pool's store)
    or None. index None runs the full sequence (filling `caches` when
    given: prefill); a 0-d or (B,) int32 tensor decodes at that position,
    writing the caches in place. pages: the page-table operand of native
    paged decode ({'table', 'size', 'len'}), threaded to every attention
    layer.
    last_only: logits for the final position only."""
    x = L.embed(params["embed"], tokens, scale=cfg.emb_scale).to(cfg.adtype())
    positions = None if index is None or cfg.is_ssm else \
        A._positions_for(index, x.shape[1], x.device)
    for li in layer_order(cfg):
        c = caches[li] if caches is not None else None
        x, _ = _layer_apply(params["layers"][li], x, cfg, layer_kind(cfg, li),
                            positions=positions, cache=c, index=index,
                            pages=pages)
    if last_only:
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, params.get("head"),
                       softcap=cfg.logit_softcap)
    return logits, caches


def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.float32, device="cuda") -> List[Dict]:
    """Per-layer decode caches: {"k", "v"} of `max_len` positions (of
    min(max_len, window) rows, circular, on a windowed layer), MLA's
    {"c_kv", "k_rope"}, or a Mamba layer's {"conv", "ssm"} (independent
    of max_len)."""
    out = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        if kind["mixer"] == "mamba":
            out.append(S.make_mamba_cache(mamba_cfg_for(cfg), batch, dtype,
                                          device))
        else:
            out.append(A.make_cache(attn_cfg_for(cfg, kind), batch, max_len,
                                    dtype, device))
    return out


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

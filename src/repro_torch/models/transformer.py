"""Dense GQA, MLA, mixture-of-experts, pure Mamba-1 and hybrid decoders,
the vision stub's backbone and the whisper encoder-decoder (port of
`repro.models.transformer`).

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
conv_w, ...}}. The jamba hybrid (`attn_period`) puts an attention mixer
at i % attn_period == attn_offset and a Mamba mixer elsewhere, each with
an FFN (MoE at i % moe_period == moe_offset, else a dense MLP). Caches are
a per-layer list of {"k", "v"} tensors (MLA: {"c_kv", "k_rope"};
models.attention), slab rows or, under a paged pool, page-major store
leaves; a Mamba layer's is {"conv", "ssm"}, always slot-major. An MoE
layer (deepseek; `prelude_layers` dense layers first) has {"ffn_norm",
"ffn": {"router": {"w"}, "w_gate", "w_up", "w_down" (raw (E, d, f)
stacks, or their packed form), "shared"?}} (models.moe). A vision-stub
model (llava, `frontend="vision"`) takes `n_img_tokens` image-embedding
rows prepended to the prompt's embeddings (`forward(img_embeds=)`;
models.frontends makes them). The encoder-decoder (whisper, `enc_dec`)
adds {"enc_layers": [{"pre_norm", "mixer", "ffn_norm", "ffn"}, ...],
"enc_norm"} (`encode`: non-causal self-attention over the audio stub's
frames), a {"cross_norm", "cross": {wq, wk, wv, wo}} pair in every decoder
layer, reading the encoder output (`forward(enc_out=)`), and "pos_table",
the sinusoidal positions of DEC_POSITIONS rows that the encoder's frames
and the decoder's tokens add, made once on the model's device (the JAX
package builds it in every forward; no checkpoint carries it). A decoder
layer's cache then holds its cross-attention's {"cross_k", "cross_v"}
beside {"k", "v"}.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import kratos as kr
from repro_torch.kernels import ops
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
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001          # MoE load-balancing coefficient
    # Mamba: is_ssm makes every layer a Mamba-1 mixer without FFN
    # (falcon); attn_period > 0 is the hybrid (jamba): attention at
    # i % attn_period == attn_offset, a Mamba mixer elsewhere, each with
    # its FFN
    is_ssm: bool = False
    attn_period: int = 0
    attn_offset: int = 4
    d_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    bcdt_rms: bool = False
    ssm_chunk: int = 256                  # JAX's XLA scan chunk (no use here)
    # encoder-decoder (whisper): n_enc_layers encoder layers over
    # enc_positions frames, and a cross-attention in every decoder layer
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_positions: int = 1500             # whisper: 30 s of frames
    # frontend stub: 'vision' prepends n_img_tokens image-embedding rows;
    # 'audio' makes the encoder's frames (enc_dec)
    frontend: Optional[str] = None
    n_img_tokens: int = 0
    # the JAX package stacks layers of one pattern slot and runs the slots'
    # stacks in turn; `layer_order` reproduces the order that gives
    scan_period: int = 1
    prelude_layers: int = 0
    # training: recompute each layer's forward in the backward pass
    # (torch.utils.checkpoint around every layer). 'dots' takes the same
    # form as 'nothing' (every activation recomputed); 'none' is off
    remat: bool = True
    remat_policy: str = "nothing"         # 'nothing' | 'dots' | 'none'
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
        """Analytic parameter count, the JAX package's formula (norms are
        not counted, and an encoder layer's MLP counts 3 d d_ff although
        it is not gated, as there)."""
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
        if self.enc_dec:
            attn = 4 * d * self.n_heads * self.dh
            total += self.n_enc_layers * (attn + 3 * d * self.d_ff)
            total += self.n_layers * attn                   # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token runs through, the JAX package's formula: an
        MoE layer's routed experts count top_k of n_experts."""
        inactive = sum(layer_kind(self, i)["ffn"] == "moe"
                       for i in range(self.n_layers)) \
            * (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.d_ff_expert
        return int(self.param_count() - inactive)


def layer_kind(cfg: ModelConfig, i: int) -> Dict[str, Any]:
    """What lives at layer i: attention or (is_ssm, or off the hybrid's
    attention slots) a Mamba mixer, and an MLP, MoE or (is_ssm) no FFN.
    With local_global_period the attention layer i is local (the config's
    window) when i % period == 0, else global (no window). With experts,
    layer i >= prelude_layers with i % moe_period == moe_offset is MoE,
    the rest dense MLP."""
    if cfg.is_ssm:
        return {"mixer": "mamba", "window": cfg.window, "ffn": "none"}
    mixer = "attn"
    if cfg.attn_period and i % cfg.attn_period != cfg.attn_offset:
        mixer = "mamba"
    window = cfg.window
    if cfg.local_global_period and mixer == "attn":
        window = cfg.window if i % cfg.local_global_period == 0 else None
    ffn = "mlp"
    if cfg.n_experts and i >= cfg.prelude_layers \
            and i % cfg.moe_period == cfg.moe_offset:
        ffn = "moe"
    return {"mixer": mixer, "window": window, "ffn": ffn}


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


def cross_cfg_for(cfg: ModelConfig, kind: Dict) -> A.AttnConfig:
    """A decoder layer's cross-attention over the encoder output."""
    return dataclasses.replace(attn_cfg_for(cfg, kind), cross=True,
                               causal=False, use_rope=False)


def enc_attn_cfg(cfg: ModelConfig) -> A.AttnConfig:
    """The encoder's self-attention: full window, non-causal, no RoPE."""
    return dataclasses.replace(attn_cfg_for(cfg, {"window": None}),
                               mla=False, use_rope=False, causal=False)


def moe_cfg_for(cfg: ModelConfig) -> M.MoEConfig:
    return M.MoEConfig(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert, n_shared=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor,
        aux_loss_coef=cfg.aux_loss_coef, activation=cfg.activation)


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


def seeded_generator(seed: int, device) -> Optional[torch.Generator]:
    """A torch.Generator on `device` seeded with `seed`, or None on the
    meta device, whose tensors hold no numbers to draw."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded torch.Generator on `device`. The
    numbers differ from the JAX package's init; parity tests carry JAX
    weights across with `checkpoint.convert` instead.

    On the meta device (shapes and dtypes, nothing allocated: what the
    dry-run builds, as the JAX package's `jax.eval_shape` of its init)
    no generator is made, since meta has none; a real device draws the
    same numbers whatever this branch does."""
    g = seeded_generator(seed, device)
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
        if cfg.enc_dec:
            layer["cross_norm"] = _norm_params(cfg, device)
            layer["cross"] = A.attn_init(cross_cfg_for(cfg, kind), cfg.kratos,
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
    if cfg.enc_dec:
        params["enc_layers"] = [{
            "pre_norm": _norm_params(cfg, device),
            "mixer": A.attn_init(enc_attn_cfg(cfg), cfg.kratos, **kw),
            "ffn_norm": _norm_params(cfg, device),
            "ffn": L.mlp_init(cfg.d_model, cfg.d_ff, gated=cfg.gated,
                              spec=cfg.kratos, **kw)}
            for _ in range(cfg.n_enc_layers)]
        params["enc_norm"] = _norm_params(cfg, device)
        params["pos_table"] = position_table(cfg.d_model, device)
    return params


# rows of the decoder's position table: the JAX package gathers decode
# positions from a table of this many rows
DEC_POSITIONS = 32768


def position_table(d: int, device, n: int = DEC_POSITIONS) -> torch.Tensor:
    """(n, d) f32 sinusoidal positions, sin on even columns and cos on odd
    ones, as the JAX package's `_sinusoidal_positions` computes them.

    The jitted reference rounds exp correctly and sin / cos to within an
    ulp; f32 `torch.exp` is an ulp off on some columns, which moves the
    angle at position p by p ulps. So exp, sin and cos run in f64 and are
    rounded, the angle itself an f32 product as there."""
    ar = torch.arange(0, d, 2, dtype=torch.float32, device=device) \
        * (-math.log(10000.0) / d)
    div = torch.exp(ar.double()).float()
    ang = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
           * div).double()
    pe = torch.empty((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang).float()
    pe[:, 1::2] = torch.cos(ang).float()
    return pe


def _remat(cfg: ModelConfig, fn, *args):
    """fn(*args), its activations recomputed in the backward pass when
    the config asks for remat, grad mode is on and the forward is the
    training step's (on `ops.reference_path`): the JAX package's
    `_remat_wrap` around each scanned layer, which its serving steps turn
    off. The recompute re-enters the reference path, whichever thread the
    backward runs on."""
    if not (cfg.remat and cfg.remat_policy != "none"
            and torch.is_grad_enabled() and ops.on_reference_path()):
        return fn(*args)

    def run(*a):
        with ops.reference_path():
            return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Whisper's encoder: frames (B, S_enc, d) of the audio stub, plus
    sinusoidal positions, through the encoder layers (pre-norm,
    non-causal flash self-attention, non-gated MLP; unscaled residuals)
    and `enc_norm`. Returns (B, S_enc, d)."""
    x = frames.to(cfg.adtype())
    x = x + params["pos_table"][:x.shape[1]].to(x.dtype)
    acfg, spec = enc_attn_cfg(cfg), cfg.kratos

    def layer(lp, x):
        h, _ = A.gqa_apply(lp["mixer"], _norm(cfg, lp["pre_norm"], x), acfg,
                           spec=spec)
        x = x + h
        return x + L.mlp_apply(lp["ffn"], _norm(cfg, lp["ffn_norm"], x),
                               activation=cfg.activation, spec=spec)

    for lp in params["enc_layers"]:
        x = _remat(cfg, layer, lp, x)
    return _norm(cfg, params["enc_norm"], x)


def _probe_fanout(cfg: ModelConfig, kind: Dict, site: str) -> int:
    """The dense GEMM fan-out a probed activation feeds (serve.ledger: the
    FLOP and byte columns are weighted by it), the JAX package's formula."""
    if site == "mixer":
        if kind["mixer"] == "mamba":
            return 2 * cfg.d_inner
        if cfg.mla:
            q = cfg.q_lora_rank if cfg.q_lora_rank \
                else cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            return int(q + cfg.kv_lora_rank + cfg.qk_rope_dim)
        return (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.dh
    if kind["ffn"] == "moe":
        return int(cfg.n_experts
                   + 2 * (cfg.top_k + cfg.n_shared_experts) * cfg.d_ff_expert)
    gated = cfg.gated_mlp if cfg.gated_mlp is not None \
        else cfg.activation in ("silu", "gelu", "gelu_tanh")
    return (2 if gated else 1) * cfg.d_ff


def _layer_apply(p: Dict, x, cfg: ModelConfig, kind: Dict, *, positions,
                 cache, index, pages, enc_out, probe=None, with_aux=False):
    """One residual block: (x, cache, aux), aux the MoE load-balancing term
    (0 for another layer; None without `with_aux`). probe (serve.ledger,
    or None) taps the normed mixer and FFN inputs here, and the merged
    attention heads and the MLP hidden activation inside."""
    spec = cfg.kratos
    aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
    h = _norm(cfg, p["pre_norm"], x)
    if probe is not None:
        probe.tap(h, _probe_fanout(cfg, kind, "mixer"))
    if kind["mixer"] == "mamba":
        # recurrent state: O(1) per slot and resident, so pages and
        # positions do not reach it
        h, cache = S.mamba_apply(p["mixer"], h, mamba_cfg_for(cfg),
                                 cache=cache, index=index, spec=spec)
    else:
        h, cache = A.attn_apply(p["mixer"], h, attn_cfg_for(cfg, kind),
                                positions=positions, cache=cache,
                                index=index, pages=pages, spec=spec,
                                probe=probe)
    if cfg.sandwich_norm:
        h = _norm(cfg, p["post_norm"], h)
    x = x + h * cfg.residual_scale
    if "cross" in p:
        # k/v from the encoder output at prefill, from the cache at decode
        cc = None if cache is None else {"k": cache["cross_k"],
                                         "v": cache["cross_v"]}
        h, _ = A.gqa_apply(p["cross"], _norm(cfg, p["cross_norm"], x),
                           cross_cfg_for(cfg, kind), cache=cc, index=index,
                           kv_source=enc_out, spec=spec, probe=probe)
        x = x + h * cfg.residual_scale
    if kind["ffn"] != "none":
        h = _norm(cfg, p["ffn_norm"], x)
        if probe is not None:
            probe.tap(h, _probe_fanout(cfg, kind, "ffn"))
    if kind["ffn"] == "moe":
        h = M.moe_apply(p["ffn"], h, moe_cfg_for(cfg), spec=spec,
                        with_aux=with_aux)
        if with_aux:
            h, aux = h
        x = x + h * cfg.residual_scale
    elif kind["ffn"] == "mlp":
        h = L.mlp_apply(p["ffn"], h, activation=cfg.activation, spec=spec,
                        probe=probe)
        if cfg.sandwich_norm:
            h = _norm(cfg, p["ffn_post_norm"], h)
        x = x + h * cfg.residual_scale
    return x.to(cfg.adtype()), cache, aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            caches: Optional[List[Dict]] = None, index=None,
            pages: Optional[Dict] = None, img_embeds=None, enc_out=None,
            last_only: bool = False, probe=None, with_aux: bool = False,
            ) -> Tuple[torch.Tensor, ...]:
    """Decoder forward. tokens: (B, S) int. Returns (f32 logits, caches),
    or (logits, aux, caches) with `with_aux`: aux the f32 sum of the MoE
    layers' load-balancing terms, as the JAX package's forward returns it
    (the training step's loss adds it).

    img_embeds: (B, n_img, d) vision-stub rows prepended to the token
    embeddings (llava); positions and cache writes count them.
    enc_out: (B, S_enc, d) encoder output (`encode`) that the
    cross-attention reads at prefill, writing it into the caches' cross
    leaves; decode reads those leaves instead (whisper). An enc_dec model
    adds sinusoidal positions to the token embeddings.

    caches: per-layer list from `make_caches` (or a paged pool's store)
    or None. index None runs the full sequence (filling `caches` when
    given: prefill); a 0-d or (B,) int32 tensor decodes at that position,
    writing the caches in place. pages: the page-table operand of native
    paged decode ({'table', 'size', 'len'}), threaded to every attention
    layer.
    last_only: logits for the final position only.
    probe: serve.ledger.LedgerProbe (or None). Every layer's taps add into
    row `li` of the probe's (n_layers, width) buffer, li the layer's place
    in the model whatever order the layers run in: the JAX package's
    matrix, whose scanned slot s, period t is layer prelude + t *
    scan_period + s.
    With `cfg.remat` and grad mode on, each layer's activations are
    recomputed in the backward pass (`_remat`); the numbers do not change."""
    x = L.embed(params["embed"], tokens, scale=cfg.emb_scale).to(cfg.adtype())
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    positions = None if index is None or cfg.is_ssm else \
        A._positions_for(index, x.shape[1], x.device)
    if cfg.enc_dec and not cfg.use_rope:
        pe = params["pos_table"]
        pe = pe[:x.shape[1]] if index is None else pe[positions.long()]
        x = x + pe.to(x.dtype)
    if pages is not None:     # the paged layers' write plan goes in here
        pages = dict(pages)
    aux = x.new_zeros((), dtype=torch.float32) if with_aux else None
    for li in layer_order(cfg):
        c = caches[li] if caches is not None else None
        if probe is not None:
            probe.layer = li

        def layer(lp, x, _kind=layer_kind(cfg, li), _c=c):
            return _layer_apply(lp, x, cfg, _kind, positions=positions,
                                cache=_c, index=index, pages=pages,
                                enc_out=enc_out, probe=probe,
                                with_aux=with_aux)

        x, _, a = _remat(cfg, layer, params["layers"][li], x)
        if with_aux:
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    x = _norm(cfg, params["final_norm"], x)
    logits = L.unembed(params["embed"], x, params.get("head"),
                       softcap=cfg.logit_softcap)
    return (logits, aux, caches) if with_aux else (logits, caches)


def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.float32, device="cuda") -> List[Dict]:
    """Per-layer decode caches: {"k", "v"} of `max_len` positions (of
    min(max_len, window) rows, circular, on a windowed layer), MLA's
    {"c_kv", "k_rope"}, or a Mamba layer's {"conv", "ssm"} (independent
    of max_len); an enc_dec decoder layer adds its cross-attention's
    {"cross_k", "cross_v"} of enc_positions rows."""
    out = []
    for i in range(cfg.n_layers):
        kind = layer_kind(cfg, i)
        if kind["mixer"] == "mamba":
            out.append(S.make_mamba_cache(mamba_cfg_for(cfg), batch, dtype,
                                          device))
        else:
            out.append(A.make_cache(attn_cfg_for(cfg, kind), batch, max_len,
                                    dtype, device))
        if cfg.enc_dec:
            shape = (batch, cfg.n_kv_heads, cfg.enc_positions, cfg.dh)
            out[-1].update(cross_k=torch.zeros(shape, dtype=dtype,
                                               device=device),
                           cross_v=torch.zeros(shape, dtype=dtype,
                                               device=device))
    return out


def noise(shape, generator: torch.Generator, device, rows=None
          ) -> torch.Tensor:
    """Uniform noise of `shape` from `generator`. rows=(first, total): the
    caller holds rows first.. of a batch of `total` (a rank's slots on a
    mesh); the noise of the whole batch is drawn and those rows kept, so
    sampled tokens do not depend on how the slots are split."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    first, total = rows
    u = torch.rand((total, *shape[1:]), generator=generator, device=device)
    return u[first:first + shape[0]]


def sample_tokens(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor, rows=None) -> torch.Tensor:
    """Per-row Gumbel-max sampling (argmax when temperature <= 0), on the
    logits' device. logits (B, vocab); temperature (B,) f32; rows: see
    `noise`. Returns (B,) int32. The noise comes from `generator`, so
    sampled tokens differ from the JAX package's; greedy rows match it."""
    logits = logits.float()
    u = noise(logits.shape, generator, logits.device, rows)
    g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    safe_t = temperature.clamp(min=1e-6)[:, None]
    scores = torch.where((temperature > 0.0)[:, None], logits / safe_t + g,
                         logits)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in f32; labels (B, S) int; mask (B, S) optional:
    the masked mean over its nonzero positions (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

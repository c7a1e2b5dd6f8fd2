"""GQA attention with sliding windows and circular KV caches (the GQA half
of `repro.models.attention`).

Caches, per layer, batch-major:
  full window:    k/v (B, KV, S_max, dh), position p at row p
  sliding window: circular buffer of W rows, position p at row p % W

Prefill (contiguous positions) runs the flash kernel through
`kernels.ops.flash_attention`. Decode writes the new K/V rows IN PLACE into
the cache tensors (the JAX package returns updated arrays; here the slab is
mutated, which saves a cache copy per step) and attends with the plain
`attention_positional`, as the JAX package does. Decode takes a scalar
index (one shared clock) or a (B,) vector of per-slot clocks (continuous
batching).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import kratos as kr
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    window: Optional[int] = None
    softcap: Optional[float] = None
    qk_norm: bool = False
    attn_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None \
            else self.head_dim ** -0.5


def attention_positional(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                         softcap=None, scale=None, extra_mask=None):
    """q: (B,H,Sq,D); k, v: (B,KV,Skv,D); GQA by broadcasting kv heads.

    q_pos (Sq,) / kv_pos (Skv,) absolute positions (kv_pos may be
    non-monotonic: circular caches); extra_mask (Skv,) validity. Any of
    them may carry a leading batch axis for per-slot clocks."""
    b, h, sq, dk = q.shape
    kv, skv = k.shape[1], k.shape[2]
    scale = (dk ** -0.5) if scale is None else scale
    if kv != h:
        g = h // kv
        k = k[:, :, None].expand(b, kv, g, skv, dk).reshape(b, h, skv, dk)
        v = v[:, :, None].expand(b, kv, g, skv, v.shape[-1]) \
            .reshape(b, h, skv, v.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if extra_mask is not None:
        mask = mask & extra_mask[..., None, :]
    mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _sdpa(q, k, v, cfg: AttnConfig):
    """Attention over a contiguous sequence from position 0: the flash
    kernel (decode, over a cache, uses `attention_positional`)."""
    return ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                               softcap=cfg.softcap, scale=cfg.scale)


def gqa_init(cfg: AttnConfig, spec: kr.KratosSpec, *, generator, device,
             dtype) -> Dict:
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "wq": kr.init(d, h * dh, spec, **kw),
        "wk": kr.init(d, kv * dh, spec, **kw),
        "wv": kr.init(d, kv * dh, spec, **kw),
        "wo": kr.init(h * dh, d, spec, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones(dh, device=device, dtype=dtype)}
        p["k_norm"] = {"scale": torch.ones(dh, device=device, dtype=dtype)}
    return p


def _positions_for(index, s: int, device) -> torch.Tensor:
    """(S,) or (B, S) int32 positions of a length-s segment at `index`
    (None = from 0; a 0-d tensor = shared clock; (B,) = per-slot clocks)."""
    ar = torch.arange(s, dtype=torch.int32, device=device)
    if index is None:
        return ar
    if index.ndim == 0:
        return index + ar
    return index[:, None] + ar[None, :]


def _split_heads(x, n, dh):
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh).transpose(1, 2)


def _merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def gqa_apply(params, x, cfg: AttnConfig, *, positions=None, cache=None,
              index=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (cache None, or prefill into `cache` with index None)
    or decode (cache and index) GQA attention. Returns (y, cache)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(kr.apply(params["wq"], x), h, dh)
    k = _split_heads(kr.apply(params["wk"], x), kv, dh)
    v = _split_heads(kr.apply(params["wv"], x), kv, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    if positions is None:
        positions = _positions_for(index, s, x.device)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if index is None:
        if cache is not None:
            _prefill_cache(cache, k, v, cfg)
        o = _sdpa(q, k, v, cfg)
    else:
        kv_pos, valid = _decode_cache_write(cache, k, v, cfg, index)
        o = attention_positional(
            q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), positions,
            kv_pos, causal=cfg.causal, window=cfg.window,
            softcap=cfg.softcap, extra_mask=valid, scale=cfg.scale)
    return kr.apply(params["wo"], _merge_heads(o)), cache


def make_gqa_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.n_kv_heads, size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _prefill_cache(cache, k, v, cfg: AttnConfig) -> None:
    """Fill a cache from a contiguous prefill of length s, in place; a
    windowed layer with s > W keeps the last W positions at their circular
    rows."""
    size = cache["k"].shape[2]
    s = k.shape[2]
    if cfg.window and s > size:
        slots = (s - size + torch.arange(size, device=k.device)) % size
        inv = torch.argsort(slots)
        cache["k"].copy_(k[:, :, -size:][:, :, inv])
        cache["v"].copy_(v[:, :, -size:][:, :, inv])
    else:
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v


def _decode_cache_write(cache, k, v, cfg: AttnConfig, index):
    """Write the s new rows at `index`.. in place; return (kv_positions,
    valid) for the positional mask. index: 0-d (shared clock) or (B,)
    per-slot clocks; windowed layers write circularly (row p % W)."""
    size = cache["k"].shape[2]
    s = k.shape[2]
    dev = k.device
    last = index + (s - 1)                        # last written position
    pos = _positions_for(index, s, dev).long()
    rows = pos % size if cfg.window else pos
    kc, vc = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    if index.ndim == 0:
        cache["k"][:, :, rows] = kc
        cache["v"][:, :, rows] = vc
    else:
        bidx = torch.arange(k.shape[0], device=dev)[:, None]
        cache["k"][bidx, :, rows] = kc.transpose(1, 2)
        cache["v"][bidx, :, rows] = vc.transpose(1, 2)
    slots = torch.arange(size, dtype=torch.int32, device=dev)
    lastc = last[..., None]
    if cfg.window:
        kv_pos = lastc - torch.remainder(lastc - slots, size)
        valid = kv_pos >= 0
    else:
        kv_pos = slots
        valid = slots <= lastc
    return kv_pos, valid

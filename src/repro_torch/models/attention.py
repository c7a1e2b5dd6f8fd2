"""GQA attention with sliding windows, circular KV caches and softcaps,
MLA (multi-head latent attention) and the whisper decoder's
cross-attention (port of `repro.models.attention`).

Caches, per layer, batch-major:
  full window:    k/v (B, KV, S_max, dh), position p at row p
  sliding window: circular buffer of W rows, position p at row p % W
  MLA:            compressed c_kv (B, S_max, r) + shared rotary key
                  k_rope (B, 1, S_max, dr), position p at row p

  paged (serve.paging): page-major (n_pages, KV, P, dh) store leaves (MLA:
                  (n_pages, P, r) and (n_pages, 1, P, dr)) read and
                  written through a (B, pp) page table
  cross-attention: k/v (B, KV, enc_positions, dh) of the encoder output,
                  written at prefill and read unchanged at every decode
                  step (slot-major and resident in a page pool too)

Prefill (contiguous positions) runs the flash kernel through
`kernels.ops.flash_attention`; the training step's forward (on
`kernels.ops.reference_path`) runs the positional einsum instead, as the
JAX package's `backend="ref"` does. Decode writes the new K/V rows IN PLACE into
the cache tensors (the JAX package returns updated arrays; here the slab or
page store is mutated, which saves a cache copy per step). Slab decode
attends with the plain `attention_positional`, as the JAX package does;
native paged decode attends through `kernels.ops.paged_attention` (the
page-table kernel) on the card and through the sliced slab-layout view on
the CPU, the JAX package's `ref` path. Decode takes a scalar index (one
shared clock) or a (B,) vector of per-slot clocks (continuous batching).
Under a mesh (distributed.sharding.use_mesh) whose 'model' axis splits a
decode cache's kv heads, a rank attends with its kv heads and their query
heads and the heads' outputs are all-gathered before `wo`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import kratos as kr
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops, ref
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
    attn_scale: Optional[float] = None   # override 1/sqrt(dh) (gemma2)
    # MLA
    mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # cross-attention (whisper decoder): k/v from the encoder output
    cross: bool = False

    @property
    def q_head_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim) if self.mla \
            else self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mla else self.head_dim

    @property
    def scale(self) -> float:
        return self.attn_scale if self.attn_scale is not None \
            else self.q_head_dim ** -0.5


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


# Above this many query rows the plain path streams over q-chunks instead
# of materializing the full (Sq, Skv) score matrix.
CHUNKED_ATTN_THRESHOLD = 4096
CHUNK_Q = 1024


def attention_chunked(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                      softcap=None, scale=None, extra_mask=None,
                      chunk: int = CHUNK_Q):
    """`attention_positional` over q-chunks of `chunk` rows (and the
    remainder), each attending to the whole k/v: peak memory is
    (B, H, chunk, Skv) scores."""
    sq = q.shape[2]
    outs = [attention_positional(
        q[:, :, i:i + chunk], k, v, q_pos[..., i:i + chunk], kv_pos,
        causal=causal, window=window, softcap=softcap, scale=scale,
        extra_mask=extra_mask) for i in range(0, sq, min(chunk, sq))]
    return torch.cat(outs, dim=2)


def _sdpa(q, k, v, cfg: AttnConfig):
    """Attention over a contiguous sequence from position 0: the flash
    kernel (decode, over a cache, uses `attention_positional`). On the
    training step's reference path it is the JAX package's `ref` branch
    instead: the positional einsum (over q-chunks past
    CHUNKED_ATTN_THRESHOLD rows), which autograd differentiates."""
    if ops.on_reference_path():
        pos = torch.arange(q.shape[2], dtype=torch.int32, device=q.device)
        attn = attention_chunked if q.shape[2] > CHUNKED_ATTN_THRESHOLD \
            else attention_positional
        return attn(q, k, v, pos, pos, causal=cfg.causal, window=cfg.window,
                    softcap=cfg.softcap, scale=cfg.scale)
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


def _local_heads(q, k, v, cache_heads: int, cfg: AttnConfig):
    """(q, k, v, split): under a mesh whose 'model' axis splits a decode
    cache's kv heads (the leaf holds `cache_heads` < n_kv_heads of them),
    this rank's kv heads of k and v and the query heads of their groups,
    and split True; the inputs unchanged and False otherwise. A split
    attention's output heads are all-gathered over 'model' before `wo`
    (`SH.all_gather_model`)."""
    kv = cfg.n_kv_heads
    if cache_heads == kv:
        return q, k, v, False
    r = SH.model_shard()[0]
    g = cfg.n_heads // kv
    lo, hi = r * cache_heads, (r + 1) * cache_heads
    kv_part = (lambda t: t[:, lo:hi]) if k is not None else (lambda t: t)
    return q[:, lo * g:hi * g], kv_part(k), kv_part(v), True


def _merge_heads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _paged_leaf_view(leaf, table, cache_len: int):
    """Contiguous (B, ..., cache_len, d) view of a page-major leaf
    (n_pages, ..., P, d) through the (B, pp) table: value-identical to the
    slab rows on every position the validity masks admit."""
    return ref.paged_view(leaf, table)[..., :cache_len, :]


def paged_writes(pages, index, b: int, s: int) -> Dict:
    """The page-table operand with the plan of writing s tokens at `index`
    added in place: position index[b] + j lands in page table[b, pos // P]
    at row pos % P ('page', 'off', (B, s); positions past the slot's
    footprint hit its sink-page tail: masked garbage), 'last' (B,) is the
    position of the final written token, and 'src' (B*s,) re-picks the
    written rows by `ref.last_write`, so that rows written twice (the sink)
    end as a sequential write leaves them on any device. Every paged layer
    of a forward writes the same rows: the first plans, on the forward's
    own copy of the operand, and the rest reuse its plan."""
    if "src" in pages:
        return pages
    idx = index.to(torch.int32)
    if idx.ndim == 0:
        idx = idx.expand(b)
    pos = idx[:, None] + torch.arange(s, dtype=torch.int32,
                                      device=idx.device)[None, :]
    size = pages["size"]
    page = torch.gather(pages["table"], 1, (pos // size).long()).long()
    off = (pos % size).long()
    pages.update(page=page, off=off, last=idx + (s - 1),
                 src=ref.last_write((page * size + off).reshape(-1)))
    return pages


def _in_write_order(x, src):
    """x (B, s, ...) with its B*s rows re-picked by `paged_writes`' src."""
    return x.reshape(-1, *x.shape[2:])[src].reshape(x.shape)


def _paged_gqa_decode(q, k, v, cfg: AttnConfig, cache, index, pages,
                      positions, out_dtype):
    """Page-table-native decode for full-window GQA layers: one indexed
    write per leaf puts the s new rows straight into their pages (no slab
    view anywhere), then attention reads through the table."""
    w = paged_writes(pages, index, q.shape[0], q.shape[2])
    page, off, last, src = w["page"], w["off"], w["last"], w["src"]
    # advanced indices at axes 0 and 2 around a sliced head axis: the
    # written block is (B, s, KV, dh)
    cache["k"][page, :, off] = _in_write_order(
        k.transpose(1, 2), src).to(cache["k"].dtype)
    cache["v"][page, :, off] = _in_write_order(
        v.transpose(1, 2), src).to(cache["v"].dtype)
    if q.device.type == "cuda":
        return ops.paged_attention(q, cache["k"], cache["v"], pages["table"],
                                   last, window=cfg.window,
                                   softcap=cfg.softcap, scale=cfg.scale)
    k_view = _paged_leaf_view(cache["k"], pages["table"], pages["len"])
    v_view = _paged_leaf_view(cache["v"], pages["table"], pages["len"])
    slots = torch.arange(pages["len"], dtype=torch.int32, device=q.device)
    valid = slots[None] <= last[:, None]
    return attention_positional(
        q, k_view.to(out_dtype), v_view.to(out_dtype), positions, slots,
        causal=cfg.causal, window=cfg.window, softcap=cfg.softcap,
        extra_mask=valid, scale=cfg.scale)


def _cross_apply(params, q, x, cfg: AttnConfig, kv_source, cache, index,
                 spec, probe=None):
    """Cross-attention over the encoder output: k/v are projected from
    `kv_source` (and written into `cache` at prefill), or read back from
    `cache` unchanged at decode; every query attends to every encoder
    position through the plain product, as the JAX package does."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    split = False
    if cache is not None and index is not None:
        k, v = cache["k"], cache["v"]
        q, _, _, split = _local_heads(q, None, None, k.shape[1], cfg)
    else:
        k = _split_heads(kr.apply(params["wk"], kv_source, spec), kv, dh)
        v = _split_heads(kr.apply(params["wv"], kv_source, spec), kv, dh)
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
    dev = x.device
    o = attention_positional(
        q, k.to(x.dtype), v.to(x.dtype),
        torch.arange(q.shape[2], dtype=torch.int32, device=dev),
        torch.arange(k.shape[2], dtype=torch.int32, device=dev),
        causal=False, softcap=cfg.softcap, scale=cfg.scale)
    if split:
        o = SH.all_gather_model(o, 1)
    return _out_proj(params, o, cfg, spec, probe), cache


def _out_proj(params, o, cfg: AttnConfig, spec, probe):
    """wo over the merged heads; a ledger probe taps its input."""
    mo = _merge_heads(o)
    if probe is not None:
        probe.tap(mo, cfg.d_model)
    return kr.apply(params["wo"], mo, spec)


def gqa_apply(params, x, cfg: AttnConfig, *, positions=None, cache=None,
              index=None, pages=None, kv_source=None,
              spec: kr.KratosSpec = kr.DENSE, probe=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (cache None, or prefill into `cache` with index None)
    or decode (cache and index) GQA attention. Returns (y, cache).

    pages: the page-table operand of native paged decode ({'table',
    'size', 'len'}); the cache leaves are then page-major. A windowed
    layer whose window is shorter than `len` keeps a resident circular
    slab leaf and ignores it.
    kv_source: the encoder output (B, S_enc, d) a `cfg.cross` layer
    projects its k/v from at prefill (decode reads them from `cache`).
    spec: the model's Kratos spec, for the training-time apply of dense
    leaves. probe: serve.ledger probe (or None): taps the merged heads
    feeding `wo`."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(kr.apply(params["wq"], x, spec), h, dh)
    if cfg.cross:
        return _cross_apply(params, q, x, cfg, kv_source, cache, index,
                            spec, probe)
    k = _split_heads(kr.apply(params["wk"], x, spec), kv, dh)
    v = _split_heads(kr.apply(params["wv"], x, spec), kv, dh)
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
        return _out_proj(params, o, cfg, spec, probe), cache
    q, k, v, split = _local_heads(q, k, v, cache["k"].shape[1], cfg)
    if pages is not None and (cfg.window is None
                              or cfg.window >= pages["len"]):
        o = _paged_gqa_decode(q, k, v, cfg, cache, index, pages, positions,
                              x.dtype)
    else:
        kv_pos, valid = _decode_cache_write(cache, k, v, cfg, index)
        o = attention_positional(
            q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), positions,
            kv_pos, causal=cfg.causal, window=cfg.window,
            softcap=cfg.softcap, extra_mask=valid, scale=cfg.scale)
    if split:
        o = SH.all_gather_model(o, 1)
    return _out_proj(params, o, cfg, spec, probe), cache


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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention): minicpm3, deepseek-v2
# ---------------------------------------------------------------------------

def mla_init(cfg: AttnConfig, spec: kr.KratosSpec, *, generator, device,
             dtype) -> Dict:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda n: {"scale": torch.ones(n, device=device, dtype=dtype)}
    p: Dict = {}
    if cfg.q_lora_rank:
        p["wq_a"] = kr.init(d, cfg.q_lora_rank, spec, **kw)
        p["q_norm"] = ones(cfg.q_lora_rank)
        p["wq_b"] = kr.init(cfg.q_lora_rank, h * cfg.q_head_dim, spec, **kw)
    else:
        p["wq"] = kr.init(d, h * cfg.q_head_dim, spec, **kw)
    p["wkv_a"] = kr.init(d, r + cfg.qk_rope_dim, spec, **kw)
    p["kv_norm"] = ones(r)
    p["wkv_b"] = kr.init(r, h * (cfg.qk_nope_dim + cfg.v_head_dim), spec,
                         **kw)
    p["wo"] = kr.init(h * cfg.v_head_dim, d, spec, **kw)
    return p


def _mla_q(params, x, cfg: AttnConfig, spec):
    """(q_nope (B,H,S,nope), q_rope (B,H,S,dr)), through the low-rank
    factors and q_norm when q_lora_rank is set, else one projection."""
    if cfg.q_lora_rank:
        qa = kr.apply(params["wq_a"], x, spec)
        q = kr.apply(params["wq_b"], L.rmsnorm(params["q_norm"], qa), spec)
    else:
        q = kr.apply(params["wq"], x, spec)
    q = _split_heads(q, cfg.n_heads, cfg.q_head_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _mla_expand_kv(params, c_kv, cfg: AttnConfig, spec):
    """(B, S, r) latent -> k_nope (B,H,S,nope), v (B,H,S,vd)."""
    kvb = _split_heads(kr.apply(params["wkv_b"], c_kv, spec), cfg.n_heads,
                       cfg.qk_nope_dim + cfg.v_head_dim)
    return kvb[..., :cfg.qk_nope_dim], kvb[..., cfg.qk_nope_dim:]


def mla_apply(params, x, cfg: AttnConfig, *, positions=None, cache=None,
              index=None, pages=None, spec: kr.KratosSpec = kr.DENSE,
              probe=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA over a full sequence (cache None, or prefill into `cache` with
    index None) or decode (cache and index: the s new latents are written
    in place at index.., s > 1 being the speculative block or suffix
    write). With `pages` the cache leaves are page-major and the latents
    land in their pages; attention reads the sliced table view. Every call
    expands the whole latent history through `wkv_b`. spec: the model's
    Kratos spec, for the training-time apply of dense leaves. probe:
    serve.ledger probe (or None): taps the merged heads feeding `wo`.
    Returns (y, cache)."""
    b, s, _ = x.shape
    h, r, dr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
    dev = x.device
    if positions is None:
        positions = _positions_for(index, s, dev)
    q_nope, q_rope = _mla_q(params, x, cfg, spec)
    q = torch.cat([q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)],
                  dim=-1)
    kv_a = kr.apply(params["wkv_a"], x, spec)
    c_kv = L.rmsnorm(params["kv_norm"], kv_a[..., :r])          # (B,S,r)
    k_rope = L.apply_rope(kv_a[..., r:][:, None], positions,
                          cfg.rope_theta)                      # (B,1,S,dr)

    kv_pos, valid = positions, None
    if index is not None and pages is not None:
        w = paged_writes(pages, index, b, s)
        page, off, last, src = w["page"], w["off"], w["last"], w["src"]
        cache["c_kv"][page, off] = _in_write_order(c_kv, src).to(
            cache["c_kv"].dtype)
        # advanced indices at axes 0 and 2 around the singleton head axis:
        # the written block is (B, s, 1, dr)
        cache["k_rope"][page, :, off] = _in_write_order(
            k_rope.transpose(1, 2), src).to(cache["k_rope"].dtype)
        c_all = _paged_leaf_view(cache["c_kv"], pages["table"], pages["len"])
        kr_all = _paged_leaf_view(cache["k_rope"], pages["table"],
                                  pages["len"])
        kv_pos = torch.arange(pages["len"], dtype=torch.int32, device=dev)
        valid = kv_pos[None] <= last[:, None]
    elif index is not None:
        # slab decode: append the latents, expand the whole cache
        pos = _positions_for(index, s, dev).long()
        cu = c_kv.to(cache["c_kv"].dtype)
        ru = k_rope.to(cache["k_rope"].dtype)
        if index.ndim == 0:
            cache["c_kv"][:, pos] = cu
            cache["k_rope"][:, :, pos] = ru
        else:                       # per-slot clocks (continuous batching)
            bidx = torch.arange(b, device=dev)[:, None]
            cache["c_kv"][bidx, pos] = cu
            cache["k_rope"][bidx, :, pos] = ru.transpose(1, 2)
        c_all, kr_all = cache["c_kv"], cache["k_rope"]
        kv_pos = torch.arange(c_all.shape[1], dtype=torch.int32, device=dev)
        valid = kv_pos <= (index + (s - 1))[..., None]
    else:
        if cache is not None:
            cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
            cache["k_rope"][:, :, :s] = k_rope.to(cache["k_rope"].dtype)
        c_all, kr_all = c_kv, k_rope

    k_nope, v = _mla_expand_kv(params, c_all.to(x.dtype), cfg, spec)
    k = torch.cat([k_nope, kr_all.to(x.dtype).expand(b, h, k_nope.shape[2],
                                                      dr)], dim=-1)
    attn = attention_chunked if s > CHUNKED_ATTN_THRESHOLD \
        else attention_positional
    o = attn(q, k, v, positions, kv_pos, causal=cfg.causal, window=cfg.window,
             softcap=cfg.softcap, extra_mask=valid, scale=cfg.scale)
    return _out_proj(params, o, cfg, spec, probe), cache


def make_mla_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, 1, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Unified entry
# ---------------------------------------------------------------------------

def attn_init(cfg: AttnConfig, spec: kr.KratosSpec, **kw) -> Dict:
    return (mla_init if cfg.mla else gqa_init)(cfg, spec, **kw)


def attn_apply(params, x, cfg: AttnConfig, **kw):
    return (mla_apply if cfg.mla else gqa_apply)(params, x, cfg, **kw)


def make_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    return (make_mla_cache if cfg.mla else make_gqa_cache)(
        cfg, batch, max_len, dtype, device)

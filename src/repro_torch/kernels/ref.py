"""Plain PyTorch versions of the port's kernels (the oracles).

Same signatures as `repro.kernels.ref`. On a CPU tensor the kernel
wrappers run these; on the card `chip_smoke.py` holds each hand-written
kernel against them. Every product is taken in f32 and cast to x's dtype
once at the end — for the quantized kernels that means the scale is
applied in f32 too (the JAX oracles dequantize or scale in x's dtype,
which for bf16 differs from the f32-flush kernels by about one ulp).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantize as qz


def dense_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w, f32 accumulation, x's dtype out."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _gather_x(x: torch.Tensor, indices: torch.Tensor, bk: int) -> torch.Tensor:
    """(m, n) -> (m, n_pb, nnz, bk): the k-blocks each output block reads."""
    m, n = x.shape
    xb = x.float().reshape(m, n // bk, bk)
    return xb[:, indices.long()]


def bsr_matmul_ref(x: torch.Tensor, blocks: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """x: (m, n); blocks: (n_pb, nnz, bk, bn); indices: int (n_pb, nnz)."""
    m = x.shape[0]
    n_pb, nnz, bk, bn = blocks.shape
    xg = _gather_x(x, indices, bk)
    y = torch.einsum("mjtk,jtkn->mjn", xg, blocks.float())
    return y.reshape(m, n_pb * bn).to(x.dtype)


def bsr_matmul_experts_ref(x: torch.Tensor, blocks: torch.Tensor,
                           indices: torch.Tensor) -> torch.Tensor:
    """Every expert's block-sparse product over one shared plan: x
    (E, m, n); blocks (E, n_pb, nnz, bk, bn) -> (E, m, n_pb * bn)."""
    return torch.stack([bsr_matmul_ref(x[e], blocks[e], indices)
                        for e in range(x.shape[0])])


def bsr_quant_matmul_ref(x: torch.Tensor, qblocks: torch.Tensor,
                         scales: torch.Tensor, indices: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """qblocks: int8 (n_pb, nnz, bk // vpb, bn) packed codes; scales: f32
    (n_pb, bn) per output channel."""
    m = x.shape[0]
    n_pb, nnz, bkp, bn = qblocks.shape
    vpb = qz.VALUES_PER_BYTE[bits]
    codes = qz.unpack_codes(qblocks.reshape(n_pb * nnz, bkp, bn)
                            .transpose(0, 1), bits)          # (bk, n_pb*nnz, bn)
    blocks = codes.transpose(0, 1).reshape(n_pb, nnz, bkp * vpb, bn)
    xg = _gather_x(x, indices, bkp * vpb)
    y = torch.einsum("mjtk,jtkn->mjn", xg, blocks.float())
    return (y * scales.float()[None]).reshape(m, n_pb * bn).to(x.dtype)


def quant_matmul_ref(x: torch.Tensor, qt: qz.QuantizedTensor) -> torch.Tensor:
    """Weight-only quantized GEMM: unpack the codes, f32 product, per-column
    scale in f32."""
    codes = qz.unpack_codes(qt.data, qt.bits)
    y = torch.matmul(x.float(), codes.float()) * qt.scale.float()
    return y.to(x.dtype)


def quant_matmul_w8a8_ref(x: torch.Tensor,
                          qt: qz.QuantizedTensor) -> torch.Tensor:
    """Fully-quantized int8 GEMM: dynamic per-row activation codes, an exact
    integer accumulation (float64 holds every partial sum exactly; f32 does
    not past 2^24), dequantized as acc_f32 * row scale * column scale."""
    if qt.bits != 8:
        raise ValueError(f"quant_matmul_w8a8 needs 8-bit weights, got {qt.bits}")
    xq, xs = qz.quantize_activations_int8(x)
    acc = torch.matmul(xq.double(), qt.data.double())
    return (acc.float() * xs * qt.scale.float()[None, :]).to(x.dtype)


def paged_view(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Contiguous per-slot view of a page-major cache leaf.

    pages: (n_pages, ..., P, d), e.g. a K/V leaf (n_pages, h_kv, P, d) or
    MLA's latent (n_pages, P, r); table: (b, pp) int page ids. Returns
    (b, ..., pp * P, d), slot b's positions in order. Sink-page (page 0)
    entries yield garbage rows the caller's position mask excludes."""
    g = pages[table.long()].movedim(1, -3)       # (b, ..., pp, P, d)
    return g.reshape(*g.shape[:-3], g.shape[-3] * g.shape[-2], g.shape[-1])


def last_write(key: torch.Tensor) -> torch.Tensor:
    """For each of a 1-D sequence of indexed writes, aimed at rows `key`,
    the index of the LAST write aimed at the same row. Writes land twice on
    a row only in the sink page (parked slots, positions past a slot's
    pages); indexing every write's value through this makes duplicates
    carry one value, so the sink ends as a sequential write leaves it (the
    last one wins, as on the CPU and in the JAX package) whatever order the
    card's threads land them in. A parked slot reads the sink, and an MoE
    decode routes its row with the live ones, so the content reaches live
    tokens."""
    ar = torch.arange(key.shape[0], device=key.device)
    return torch.where(key[:, None] == key[None, :], ar, -1).amax(dim=1)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, table: torch.Tensor,
                        last: torch.Tensor, *, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Oracle of the page-table-native decode attention: q (b, h, sq, d),
    k/v pages (n_pages, h_kv, P, d), table (b, pp), last (b,) the position
    of each slot's final query row. Position j is live for query row i of
    slot b iff j <= last[b] - (sq - 1) + i (and inside the window)."""
    b, h, sq, d = q.shape
    h_kv = k_pages.shape[1]
    scale = (d ** -0.5) if scale is None else scale
    k = paged_view(k_pages, table)
    v = paged_view(v_pages, table)
    if h != h_kv:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = (last.long()[:, None] - (sq - 1)
            + torch.arange(sq, device=q.device)[None, :])        # (b, sq)
    kpos = torch.arange(k.shape[2], device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]               # (b, sq, skv)
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    s = s.masked_fill(~mask[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (b, h, s, d) with equal head counts."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def ssm_scan_ref(u: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor):
    """Mamba-1 selective scan, the sequential recurrence with an f32 state:
    h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t, y_t = c_t . h_t.
    u, dt: (B, S, di); b, c: (B, S, st); a: (di, st). Returns (y in u's
    dtype, h_final (B, di, st) f32). One step at a time, so the
    (B, S, di, st) decay and update tensors are never materialised."""
    uf, dtf, bf, cf = u.float(), dt.float(), b.float(), c.float()
    af = a.float()
    h = uf.new_zeros((u.shape[0], u.shape[2], a.shape[1]))
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * af)
        dbx = (dtf[:, t] * uf[:, t])[:, :, None] * bf[:, t, None, :]
        h = da * h + dbx
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h

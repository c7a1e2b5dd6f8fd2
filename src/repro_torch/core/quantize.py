"""Symmetric per-output-channel quantization with sub-byte bit-packing.

Port of `repro.core.quantize`, byte-for-byte: `w ~= q * scale` with q in
[-qmax, qmax] (8 bits: 127, 4 bits: 7, 2 bits: ternary with the TWN scale,
1 bit: sign with the abs-mean scale). Codes are packed along axis 0 (the
reduction axis of `y = x @ w`), little-endian within a byte (value i of a
group at bit offset i * bits), in two's complement; 1-bit stores the sign
bit (1 = positive). `torch.round` and `jnp.round` both round half to even,
so the codes match the JAX package exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

VALUES_PER_BYTE = {8: 1, 4: 2, 2: 4, 1: 8}
QMAX = {8: 127, 4: 7, 2: 1, 1: 1}
SUPPORTED_BITS = (8, 4, 2, 1)


@dataclasses.dataclass
class QuantizedTensor:
    """Packed integer data + per-channel scales for a 2-D weight."""

    data: torch.Tensor    # int8 (n_in // values_per_byte, n_out)
    scale: torch.Tensor   # f32 (n_out,)
    bits: int
    shape: Tuple[int, int]

    @property
    def packed_bytes(self) -> int:
        return self.data.numel() + 4 * self.scale.numel()


def _check_bits(bits: int) -> None:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")


def _sum0(a: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in the order of the JAX package's reductions (XLA's
    CPU backend, eager or jitted, rewrites a long reduction as a tree):
    windows of 32 rows, the zero pad split low and high (low = pad // 2),
    each window summed row by row from 0, until 32 rows or fewer are left,
    which are summed row by row. Plain adds, so the card sums alike."""
    while a.shape[0] > 32:
        m = -(-a.shape[0] // 32)
        pad = m * 32 - a.shape[0]
        a = torch.cat([a.new_zeros((pad // 2, *a.shape[1:])), a,
                       a.new_zeros((pad - pad // 2, *a.shape[1:]))])
        a = a.reshape(m, 32, *a.shape[1:])
        acc = torch.zeros_like(a[:, 0])
        for i in range(32):
            acc = acc + a[:, i]
        a = acc
    acc = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        acc = acc + a[i]
    return acc


def _mean(w: torch.Tensor, axis: int) -> torch.Tensor:
    """The JAX package's mean: the sum times the f32 reciprocal of the
    count (jnp.mean divides by a constant, which XLA turns into that)."""
    recip = float(np.float32(1.0) / np.float32(w.shape[axis]))
    return _sum0(w.movedim(axis, 0)) * recip


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c rounded once to a's dtype from f32, as XLA's CPU backend
    fuses a multiply that feeds an add under jax.jit. The product of two
    f32 values is exact in f64, so the f64 sum rounds only where the exact
    value lies within 2^-53 of an f32 tie; the tests hold this form to
    jax.jit bit for bit."""
    return (a.double() * float(np.float32(b)) + float(np.float32(c))) \
        .float().to(a.dtype)


def _twn_threshold(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Ternary Weight Networks threshold: 0.7 * mean|w| per channel."""
    return 0.7 * _mean(torch.abs(w), axis) + 1e-12


def compute_scale(w: torch.Tensor, bits: int, axis: int = 0, *,
                  jitted: bool = False) -> torch.Tensor:
    """Per-channel scale: abs-max / qmax (8, 4 bits), TWN (2), abs-mean (1).

    The 8- and 4-bit scale takes two forms, as in the JAX package: eager
    (`jitted=False`, how its registry packs projections) divides exactly;
    under jax.jit (the expert fake-quant inside the forward) XLA computes
    one FMA of abs-max, the f32 reciprocal of qmax and 1e-12. The 2- and
    1-bit scales are the same in both."""
    _check_bits(bits)
    if bits == 1:
        return _mean(torch.abs(w), axis) + 1e-12
    if bits == 2:
        aw = torch.abs(w)
        keep = aw > _twn_threshold(w, axis).unsqueeze(axis)
        num = _sum0(torch.where(keep, aw, torch.zeros_like(aw)).movedim(axis, 0))
        den = torch.clamp(torch.sum(keep, dim=axis), min=1)
        return num / den + 1e-12
    amax = torch.amax(torch.abs(w), dim=axis)
    if jitted:
        return _fma(amax, 1.0 / QMAX[bits], 1e-12)
    # qmax as a 0-d tensor on w's device: CUDA turns a division by a Python
    # scalar into a multiply by its reciprocal, which moves some scales by
    # an ulp (and flips codes near a rounding tie) off the CPU's and the
    # JAX package's true division
    qmax = torch.full((), QMAX[bits], dtype=w.dtype, device=w.device)
    return amax / qmax + 1e-12


def quantize_values(w: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Float weight -> int8 codes in [-qmax, qmax] (unpacked)."""
    _check_bits(bits)
    if bits == 1:
        return torch.where(w >= 0, 1, -1).to(torch.int8)
    if bits == 2:
        thr = _twn_threshold(w, 0).unsqueeze(0)
        return torch.where(torch.abs(w) > thr, torch.sign(w),
                           torch.zeros_like(w)).to(torch.int8)
    q = torch.round(w / scale)
    return torch.clamp(q, -QMAX[bits], QMAX[bits]).to(torch.int8)


def pack_codes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int8 codes along axis 0: `vpb` codes per output byte."""
    _check_bits(bits)
    vpb = VALUES_PER_BYTE[bits]
    if vpb == 1:
        return q
    n_in = q.shape[0]
    if n_in % vpb:
        raise ValueError(f"n_in={n_in} not divisible by values-per-byte={vpb}")
    if bits == 1:
        qu = (q > 0).to(torch.int32)
    else:
        qu = q.to(torch.int32) & ((1 << bits) - 1)      # two's-complement field
    qu = qu.reshape(n_in // vpb, vpb, *q.shape[1:])
    acc = torch.zeros_like(qu[:, 0])
    for i in range(vpb):
        acc = acc | (qu[:, i] << (i * bits))
    return acc.to(torch.uint8).view(torch.int8)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of pack_codes: int8 packed -> int8 codes (sign-extended)."""
    _check_bits(bits)
    vpb = VALUES_PER_BYTE[bits]
    if vpb == 1:
        return packed
    pu = packed.view(torch.uint8).to(torch.int32)
    mask = (1 << bits) - 1
    sign = 1 << (bits - 1)
    fields = []
    for i in range(vpb):
        f = (pu >> (i * bits)) & mask
        f = f * 2 - 1 if bits == 1 else (f ^ sign) - sign
        fields.append(f.to(torch.int8))
    out = torch.stack(fields, dim=1)                    # (n_packed, vpb, ...)
    return out.reshape(packed.shape[0] * vpb, *packed.shape[1:])


def quantize(w: torch.Tensor, bits: int) -> QuantizedTensor:
    """Quantize a (n_in, n_out) weight to a packed QuantizedTensor."""
    _check_bits(bits)
    scale = compute_scale(w, bits, axis=0)
    q = quantize_values(w, scale, bits)
    return QuantizedTensor(data=pack_codes(q, bits),
                           scale=scale.to(torch.float32), bits=bits,
                           shape=tuple(w.shape))


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """codes * scale in `dtype` (the JAX package's dequantize)."""
    codes = unpack_codes(qt.data, qt.bits)
    return codes.to(dtype) * qt.scale.to(dtype)


def fake_quantize(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize round trip of a (n_in, n_out) weight in its own
    float dtype: the JAX package's QAT forward (codes * scale), with the
    scale jax.jit computes (the reference fake-quantizes inside its jitted
    forward)."""
    scale = compute_scale(w, bits, axis=0, jitted=True)
    q = quantize_values(w, scale, bits).to(w.dtype)
    return q * scale.to(w.dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Dynamic per-row symmetric int8 activation quantization (for w8a8).

    x: (..., k) -> (codes int8 (..., k), scale f32 (..., 1)), as jax.jit of
    the JAX package's function computes it (it runs inside the jitted step):
    the scale is one FMA of the row's abs-max, the f32 reciprocal of 127
    and 1e-12, rounded once to x's dtype; then x / scale in x's dtype,
    round half to even, clip. Only the scale is cast to f32."""
    scale = _fma(torch.amax(torch.abs(x), dim=-1, keepdim=True), 1.0 / 127.0,
                 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)

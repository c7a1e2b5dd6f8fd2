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


def _twn_threshold(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Ternary Weight Networks threshold: 0.7 * mean|w| per channel."""
    return 0.7 * torch.mean(torch.abs(w), dim=axis) + 1e-12


def compute_scale(w: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Per-channel scale: abs-max / qmax (8, 4 bits), TWN (2), abs-mean (1)."""
    _check_bits(bits)
    if bits == 1:
        return torch.mean(torch.abs(w), dim=axis) + 1e-12
    if bits == 2:
        aw = torch.abs(w)
        keep = aw > _twn_threshold(w, axis).unsqueeze(axis)
        num = torch.sum(torch.where(keep, aw, torch.zeros_like(aw)), dim=axis)
        den = torch.clamp(torch.sum(keep, dim=axis), min=1)
        return num / den + 1e-12
    # qmax as a 0-d tensor on w's device: CUDA turns a division by a Python
    # scalar into a multiply by its reciprocal, which moves some scales by
    # an ulp (and flips codes near a rounding tie) off the CPU's and the
    # JAX package's true division
    qmax = torch.full((), QMAX[bits], dtype=w.dtype, device=w.device)
    return torch.amax(torch.abs(w), dim=axis) / qmax + 1e-12


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
    float dtype: the JAX package's QAT forward (codes * scale)."""
    scale = compute_scale(w, bits, axis=0)
    q = quantize_values(w, scale, bits).to(w.dtype)
    return q * scale.to(w.dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Dynamic per-row symmetric int8 activation quantization (for w8a8).

    x: (..., k) -> (codes int8 (..., k), scale f32 (..., 1)). Computed in
    x's dtype step by step as the JAX package does (abs-max, / 127, + 1e-12,
    round half to even, clip), so the codes match it byte for byte in bf16
    too; only the scale is cast to f32."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)

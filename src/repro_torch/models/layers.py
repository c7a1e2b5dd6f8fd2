"""Shared model building blocks: norms, RoPE, MLPs, embeddings.

Port of `repro.models.layers` (the sharding annotations have no
counterpart on one card). Every projection goes through `core.kratos`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import kratos as kr


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6,
            scale_plus_one: bool = False) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    s = params["scale"].float()
    if scale_plus_one:
        s = s + 1.0
    return (h * s).to(x.dtype)


def layernorm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * params["scale"].float() + params["bias"].float()).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Interleaved RoPE (pairs x[..., 0::2], x[..., 1::2]).
    x: (B, H, S, Dh); positions: (S,) or (B, S) absolute."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = positions.to(torch.float32)[..., :, None] * inv      # (..., S, dh/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    if ang.ndim == 2:
        sin, cos = sin[None, None], cos[None, None]
    else:
        sin, cos = sin[:, None], cos[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


ACTIVATIONS = {
    "silu": F.silu,
    # jax.nn.gelu's default (approximate=True): the tanh form, which the
    # reference serves whisper with (the published model uses the erf form)
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),     # nemotron squared-ReLU
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def mlp_init(d: int, d_ff: int, *, gated: bool, spec: kr.KratosSpec,
             generator: torch.Generator, device, dtype) -> Dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {}
    if gated:
        p["w_gate"] = kr.init(d, d_ff, spec, **kw)
    p["w_up"] = kr.init(d, d_ff, spec, **kw)
    p["w_down"] = kr.init(d_ff, d, spec, **kw)
    return p


def mlp_apply(params: Dict, x: torch.Tensor, *, activation: str = "silu",
              spec: kr.KratosSpec = kr.DENSE, probe=None) -> torch.Tensor:
    """spec: the model's Kratos spec, read by the training-time apply of
    dense leaves (packed leaves carry their own). probe: serve.ledger
    probe (or None): taps the hidden activation feeding w_down, where
    ReLU-family nonlinearities make real zeros."""
    act = ACTIVATIONS[activation]
    up = kr.apply(params["w_up"], x, spec)
    if "w_gate" in params:
        h = act(kr.apply(params["w_gate"], x, spec)) * up
    else:
        h = act(up)
    if probe is not None:
        probe.tap(h, x.shape[-1])
    return kr.apply(params["w_down"], h, spec)


def embed(params: Dict, tokens: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    out = torch.index_select(params["emb"], 0, tokens.reshape(-1))
    out = out.reshape(*tokens.shape, out.shape[-1])
    return out * scale if scale != 1.0 else out


def unembed(params: Dict, x: torch.Tensor, head: Optional[Dict] = None, *,
            softcap: Optional[float] = None) -> torch.Tensor:
    """f32 logits. The head product stays a plain matmul (the JAX package
    leaves it to an XLA einsum outside any kernel)."""
    w = head["w"] if head is not None else params["emb"].T
    logits = torch.matmul(x.float(), w.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits

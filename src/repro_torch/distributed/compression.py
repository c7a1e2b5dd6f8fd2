"""Gradient compression with error feedback (port of the numerics of
`repro.distributed.compression`).

`ef_int8_compress` quantizes every gradient leaf to int8 with one scale
per leaf, after adding the error-feedback residual the last step left; the
residual rides in the train state (`state["comp"]`, checkpointed with it).
It plugs into `distributed.steps.make_train_step(compress_fn=...)`. The
codes equal the JAX package's under jax.jit bit for bit: XLA fuses the
scale's `max|x| / 127 + 1e-12` into one FMA with the f32 reciprocal of
127 (`core.quantize._fma`), divides x by the scale exactly, and fuses the
residual's multiply-subtract into one FMA. The wire
pattern, `cross_pod_psum_int8` (int8 codes summed across pods), is
multi-device (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as tu
from repro_torch.core import quantize as qz


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 0-d scale) of x: round half to even, clip 127."""
    scale = qz._fma(torch.amax(torch.abs(x)), 1.0 / 127.0, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_compress(grads, state):
    """(dequantized grads in each leaf's dtype, new f32 residuals).
    state: residuals laid out like grads, or None on the first step."""
    if state is None:
        state = ef_init(grads)

    def one(g, e):
        gf = g.float() + e
        q, scale = _quant_int8(gf)
        deq = q.float() * scale
        # gf - q * scale rounded once, as XLA fuses it into an FMA (the
        # product of an int8 code and an f32 scale is exact in f64)
        resid = (gf.double() - q.double() * scale.double()).float()
        return deq.to(g.dtype), resid

    out = tu.tree_map(one, grads, state)
    return (tu.tree_map(lambda o: o[0], out, is_leaf=_pair),
            tu.tree_map(lambda o: o[1], out, is_leaf=_pair))


def _pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 \
        and all(isinstance(t, torch.Tensor) for t in x)


def ef_init(params):
    return tu.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)

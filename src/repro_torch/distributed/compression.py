"""Gradient compression with error feedback (port of the numerics of
`repro.distributed.compression`).

`ef_int8_compress` quantizes every gradient leaf to int8 with one scale
per leaf, after adding the error-feedback residual the last step left; the
residual rides in the train state (`state["comp"]`, checkpointed with it).
It plugs into `distributed.steps.make_train_step(compress_fn=...)`. The
codes equal the JAX package's under jax.jit bit for bit: XLA fuses the
scale's `max|x| / 127 + 1e-12` into one FMA with the f32 reciprocal of
127 (`core.quantize._fma`), divides x by the scale exactly, and fuses the
residual's multiply-subtract into one FMA.

`cross_pod_psum_int8` is the wire pattern across pods: each rank of the
mesh axis quantizes its partial sum, the ranks agree on the largest
scale (an all-reduce MAX), sum the int32 codes (an all-reduce SUM) and
dequantize with that scale.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as tu
from repro_torch.core import quantize as qz
from repro_torch.distributed import sharding as SH


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


def cross_pod_psum_int8(x: torch.Tensor, mesh, axis: str = "pod"
                        ) -> torch.Tensor:
    """All-reduce `x` over `axis` of `mesh` with int8 codes on the wire
    (int32 accumulate): each rank holds its own partial sum; the codes are
    taken at the largest scale over the axis, so they are comparable, and
    the sum of the codes is dequantized with it. Returns the f32 sum on
    every rank."""
    import torch.distributed as dist
    group = SH.axis_group(mesh, axis)
    _, scale = _quant_int8(x)
    smax = scale.clone()
    if group is not None:
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int32)
    if group is not None:
        dist.all_reduce(q, group=group)
    return q.float() * smax

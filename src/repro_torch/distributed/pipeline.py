"""GPipe-style pipeline parallelism over the 'pod' mesh axis (port of
`repro.distributed.pipeline`).

Each rank of the axis is one stage: stage s keeps row s of the stacked
stage parameters. A step runs `n_micro` microbatches; at tick t, stage s
processes microbatch t - s and sends its activation to stage s + 1 (the
pipeline diagonal, with n_stages - 1 bubble ticks). The send is a
`torch.autograd.Function` whose backward is the opposite shift, so
autograd runs the mirrored schedule: every rank's graph holds every tick's
shift (each rank records its activations as the last stage does, then
masks them), so the ranks' backward passes issue the same sends and
receives in the same order. The last stage's outputs reach every rank by
a sum over the axis of the masked outputs; its backward passes each
rank's own cotangent through (the loss is the same on every rank), so the
stacked parameters' gradient on rank s is stage s's row, and its sum over
the axis is the sequential gradient.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.distributed import sharding as SH


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send x to the rank `shift` places on in the group (cyclically) and
    return what the rank `shift` places back sent."""
    if group is None:
        return x.clone()
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    i = ranks.index(dist.get_rank())
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(i + shift) % n],
                      group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    """JAX's ppermute by one stage; its backward is the opposite one."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -ctx.shift), None, None


class _SumOut(torch.autograd.Function):
    """Sum over the group (the masked outputs: the last stage's reach every
    rank); the backward passes the rank's own cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(stage_params: Any, x: torch.Tensor, stage_fn: Callable,
                   mesh, axis: str = "pod") -> torch.Tensor:
    """Run x (n_micro, micro_batch, d) through the n_stages stages laid out
    along `axis` of `mesh`; stage_params' leaves are stacked (n_stages,
    ...), stage_fn(params_slice, h) -> h. Returns the last stage's
    (n_micro, micro_batch, d) outputs on every rank."""
    n_stages = SH.mesh_axes(mesh)[axis]
    n_micro = x.shape[0]
    assert n_micro >= n_stages, "need >= n_stages microbatches to fill the pipe"
    group = SH.axis_group(mesh, axis)
    stage = SH.coordinate(mesh)[axis]
    params = tu.tree_map(lambda p: p[stage], stage_params)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    buf = torch.zeros_like(x[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (when valid); the others take buf
        h_in = torch.where(first, x[t if t < n_micro else 0], buf)
        h_out = stage_fn(params, h_in)
        if t >= n_stages - 1:
            outs.append(h_out)
        buf = _PPermute.apply(h_out, group, 1)
    outs = torch.where(last, torch.stack(outs), torch.zeros_like(x))
    return _SumOut.apply(outs, group)


def pipeline_reference(stage_params, x: torch.Tensor,
                       stage_fn: Callable) -> torch.Tensor:
    """Sequential oracle: every stage in order on each microbatch."""
    n_stages = tu.leaves(stage_params)[0].shape[0]

    def apply_all(h):
        for s in range(n_stages):
            h = stage_fn(tu.tree_map(lambda p: p[s], stage_params), h)
        return h

    return torch.stack([apply_all(x[i]) for i in range(x.shape[0])])

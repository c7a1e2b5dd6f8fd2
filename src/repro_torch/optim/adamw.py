"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
`repro.optim.adamw`).

State: {"m", "v"} laid out like the parameters (None at a non-float
leaf), in `state_dtype`, and "count", an int32 0-d tensor. The update runs
in f32 and writes the parameters, `m` and `v` IN PLACE, one leaf at a
time (the JAX package returns new arrays): the card then holds one copy
of each, and the temporaries are one leaf's. Weight decay applies to
every float leaf, as in the reference (norms and embeddings included).
`chunk_stacked_update` (the reference's `lax.map` over a stacked layer
axis) has no counterpart: the port's layers are not stacked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as tu


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"
    chunk_stacked_update: bool = False
    chunk_threshold_elems: int = 1 << 24


def warmup_cosine(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at `step` (int or 0-d tensor), f32: linear warmup
    to cfg.lr, then a cosine down to min_lr_ratio * lr at total_steps."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tu.leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most max_norm, the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tu.tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _is_float_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def adamw_init(params, cfg: OptimizerConfig) -> Dict[str, Any]:
    dt = getattr(torch, cfg.state_dtype)

    def zeros(x):
        return torch.zeros(x.shape, dtype=dt, device=x.device) \
            if _is_float_leaf(x) else None

    count_dev = next((x.device for x in tu.leaves(params)), "cpu")
    return {"m": tu.tree_map(zeros, params), "v": tu.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=count_dev)}


def adamw_update(grads, opt_state, params, cfg: OptimizerConfig,
                 lr: Optional[torch.Tensor] = None):
    """Returns (params, opt_state, grad_norm): the same trees, updated in
    place, and a new count."""
    if cfg.chunk_stacked_update:
        raise NotImplementedError(
            "chunk_stacked_update maps the update over a stacked layer "
            "axis; the port's layers are not stacked")
    count = opt_state["count"] + 1
    if cfg.clip_norm is not None:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    lr = warmup_cosine(cfg, count) if lr is None else lr
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** count.to(torch.float32)
    c2 = 1 - b2 ** count.to(torch.float32)

    def upd(p, g, m, v):
        if g is None or not _is_float_leaf(p):
            return
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)

    with torch.no_grad():
        tu.tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, gn


def make_optimizer(cfg: OptimizerConfig):
    return (lambda p: adamw_init(p, cfg),
            lambda g, s, p, lr=None: adamw_update(g, s, p, cfg, lr))

"""Mixture-of-experts: shared + routed experts with top-k capacity routing
(port of `repro.models.moe`; deepseek-moe-16b, deepseek-v2-lite).

Routing is the reference's grouped sort: tokens route in groups (one per
batch row for a sequence, one global group of all B rows for a decode step,
S == 1), and within a group: softmax gates -> top-k -> renormalize
(unless `router_norm_topk` is off) ->
stable sort of the (token, k) assignments by expert -> each expert takes
its contiguous run up to the capacity C = capacity(cfg, group tokens);
overflow assignments drop (the residual passes through). Every row of a
decode step routes, parked and finished slots included, so they take
capacity as in the JAX engine.

Everything is static-shaped and gather-based, so a decode step captures
into a CUDA graph: no host sync, no data-dependent shape, and no float
atomics. The reference scatter-adds expert outputs back to token order;
here each token gathers its <= k slot outputs (zero where dropped) and sums
them in ascending slot order, the order that scatter visits them, so the
result does not depend on the device's atomic order.

The expert FFN runs on (E, G * C, d) expert batches. Routed stacks are
packed once at load (`core.kratos.pack_experts`): under a block-sparse
tree spec each projection is one expert-batched `bsr_matmul` launch, the
counterpart of the reference's `jax.vmap` over its Pallas call; otherwise
the float stack is a batched plain product, as the reference's einsum.
In training (`kernels.ops.reference_path`) the stacks stay raw: under a
tree spec each expert's projection is the training-time Kratos apply
(fake-quant, the kept blocks' plain product), as the reference vmaps
`kratos.apply` over experts, and `with_aux=True` adds the reference's
load-balancing term, over the same routing groups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import kratos as kr
from repro_torch.models import layers as L

EXPERT_STACKS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True       # normalize top-k weights (deepseek)
    aux_loss_coef: float = 0.001
    activation: str = "silu"


def moe_init(cfg: MoEConfig, spec: kr.KratosSpec = kr.DENSE, *,
             generator: torch.Generator, device, dtype) -> Dict:
    """Random router, raw (E, d, f) expert stacks and the shared experts'
    gated MLP; scaled in place (a full stack is 738 MB in f32)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    kw = dict(generator=generator, device=device)
    p = {
        "router": {"w": torch.randn((d, e), dtype=torch.float32,
                                    **kw).mul_(d ** -0.5)},
        "w_gate": torch.randn((e, d, f), dtype=dtype, **kw).mul_(d ** -0.5),
        "w_up": torch.randn((e, d, f), dtype=dtype, **kw).mul_(d ** -0.5),
        "w_down": torch.randn((e, f, d), dtype=dtype, **kw).mul_(f ** -0.5),
    }
    if cfg.n_shared:
        p["shared"] = L.mlp_init(d, cfg.n_shared * f, gated=True, spec=spec,
                                 dtype=dtype, **kw)
    return p


def capacity(cfg: MoEConfig, group_tokens: int) -> int:
    c = int(-(-group_tokens * cfg.top_k // cfg.n_experts)
            * cfg.capacity_factor)
    return max(cfg.top_k, min(c, group_tokens))


def pack_moe(p: Dict, spec: kr.KratosSpec, *, consume: bool = False
             ) -> Dict:
    """One MoE layer's routed stacks frozen for serving as the JAX package
    runs them (`repro.models.moe._expert_ffn`): through the training-time
    block-sparse apply (`kratos.pack_experts`) only under a tree spec with
    a block plan for (d_model, d_ff_expert), read off w_gate (E, d, f);
    under any other spec (dense, bits-only, w8a8, systolic) the raw float
    stacks stay, unquantized, for the reference's einsum. consume: take
    each stack out of `p` as it is packed, so its float copy can free
    before the next one packs."""
    _, d, f = (int(v) for v in p["w_gate"].shape)
    take = p.pop if consume else p.__getitem__
    if not _tree(d, f, spec):
        return {name: take(name) for name in EXPERT_STACKS}
    return {name: kr.pack_experts(take(name), spec) for name in EXPERT_STACKS}


def _tree(d: int, f: int, spec: kr.KratosSpec) -> bool:
    """Whether the routed stacks take the block-sparse tree path: a tree
    spec with a block plan for (d_model, d_ff_expert), the reference's
    rule (`repro.models.moe._expert_ffn`)."""
    return (not spec.is_identity and spec.impl == "tree"
            and kr.plan_for(d, f, spec) is not None)


def _route(xg: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
           c: int):
    """Route G groups of T tokens at once. xg: (G, T, d). Returns
    slot_token (G, E*C) int64 (0 where the slot is empty), slot_valid
    (G, E*C), assign_slot (G, T*k) int64 (the slot each (token, k)
    assignment landed in, E*C where it dropped), its weight (G, T*k), and
    the gates (G, T, E) and top experts (G, T, k) the aux term reads."""
    g, t, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    logits = torch.matmul(xg.float(), router_w.float())          # (G, T, E)
    gates = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(gates, k, dim=-1)                   # (G, T, k)
    if cfg.router_norm_topk:
        top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)
    flat_e = top_e.reshape(g, t * k)
    flat_w = top_w.reshape(g, t * k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    bounds = torch.searchsorted(
        sorted_e, torch.arange(e + 1, device=dev).expand(g, e + 1)
        .contiguous())                                            # (G, E+1)
    starts = bounds[:, :e]
    # assignment side: position in its expert's run, its slot or the drop
    pos_in_e = torch.arange(t * k, device=dev) - torch.gather(starts, 1,
                                                              sorted_e)
    slot = torch.where(pos_in_e < c, sorted_e * c + pos_in_e, e * c)
    assign_slot = torch.empty_like(slot).scatter_(1, order, slot)
    # slot side: slot (expert x, row r) holds sorted assignment starts[x] + r
    rows = torch.arange(c, device=dev)
    slot_valid = (rows < (bounds[:, 1:] - starts)[..., None]).reshape(g, e * c)
    at = torch.where(slot_valid, (starts[..., None] + rows).reshape(g, e * c),
                     0)
    slot_assign = torch.gather(order, 1, at)
    slot_token = torch.where(slot_valid, slot_assign // k, 0)
    return slot_token, slot_valid, assign_slot, flat_w, gates, top_e


def _expert_ffn(p: Dict, xe: torch.Tensor, cfg: MoEConfig,
                spec: kr.KratosSpec = kr.DENSE) -> torch.Tensor:
    """xe: (E, M, d) -> (E, M, d), every expert's gated FFN. Raw stacks
    under a tree spec (training) apply expert by expert."""
    act = L.ACTIVATIONS[cfg.activation]
    if isinstance(p["w_gate"], torch.Tensor) \
            and _tree(cfg.d_model, cfg.d_ff_expert, spec):
        def proj(name, h):
            return torch.stack([kr.apply({"w": p[name][i]}, h[i], spec)
                                for i in range(h.shape[0])])
    else:
        def proj(name, h):
            return kr.apply_experts(p[name], h)
    return proj("w_down", act(proj("w_gate", xe)) * proj("w_up", xe))


def moe_apply(params: Dict, x: torch.Tensor, cfg: MoEConfig, *,
              spec: kr.KratosSpec = kr.DENSE, with_aux: bool = False):
    """x: (B, S, d) -> y (B, S, d), or (y, aux) with `with_aux`: the
    reference's load-balancing term aux_loss_coef * E * the mean over
    routing groups of sum_e (dispatch share_e * k) * (mean gate_e), a
    scalar f32 whose gradient flows through the gates. spec: the model's
    Kratos spec, for the training-time apply of raw stacks and dense
    leaves."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_groups, g_tokens = (b, s) if s > 1 else (1, b * s)
    c = capacity(cfg, g_tokens)
    xg = x.reshape(n_groups, g_tokens, d)
    slot_token, slot_valid, assign_slot, weight, gates, top_e = _route(
        xg, params["router"]["w"], cfg, c)
    # dispatch: (G, E*C, d), empty slots zero
    xe = torch.gather(xg, 1, slot_token[..., None].expand(-1, -1, d))
    xe = xe * slot_valid[..., None].to(xe.dtype)
    xe = xe.reshape(n_groups, e, c, d).transpose(0, 1) \
        .reshape(e, n_groups * c, d)
    ye = _expert_ffn(params, xe, cfg, spec)
    ye = ye.reshape(e, n_groups, c, d).transpose(0, 1) \
        .reshape(n_groups, e * c, d)
    # combine: each token's assignments in ascending slot order; a dropped
    # one reads the zero row past the last slot
    ye = torch.cat([ye, ye.new_zeros((n_groups, 1, d))], dim=1)
    slots, perm = torch.sort(assign_slot.reshape(n_groups, g_tokens, k),
                             dim=-1)
    w = torch.gather(weight.reshape(n_groups, g_tokens, k), 2, perm)
    y = torch.zeros((n_groups, g_tokens, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        rows = torch.gather(ye, 1, slots[..., j, None].expand(-1, -1, d))
        y = y + rows * w[..., j, None].to(x.dtype)
    y = y.reshape(b, s, d)
    if cfg.n_shared:
        y = y + L.mlp_apply(params["shared"], x, activation=cfg.activation,
                            spec=spec)
    if not with_aux:
        return y
    dispatch = torch.nn.functional.one_hot(top_e, e).float().mean(
        dim=(1, 2)) * k                                            # (G, E)
    aux = cfg.aux_loss_coef * e * torch.mean(
        torch.sum(dispatch * gates.mean(dim=1), dim=-1))
    return y, aux


def moe_ref(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense per-token oracle (no capacity drops) for tests: every expert
    on every token, each token's top-k outputs weighted. Takes raw float
    stacks."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates = torch.softmax(torch.matmul(xf.float(),
                                       params["router"]["w"].float()), -1)
    top_w, top_e = torch.topk(gates, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)
    act = L.ACTIVATIONS[cfg.activation]
    outs = torch.stack([
        (act(xf @ params["w_gate"][i].to(x.dtype))
         * (xf @ params["w_up"][i].to(x.dtype))) @ params["w_down"][i]
        .to(x.dtype) for i in range(cfg.n_experts)])               # (E, T, d)
    tok = torch.arange(xf.shape[0], device=x.device)[:, None]
    sel = outs[top_e, tok]                                        # (T, k, d)
    y = torch.sum(sel * top_w[..., None].to(x.dtype), dim=1).reshape(b, s, d)
    if cfg.n_shared:
        y = y + L.mlp_apply(params["shared"], x, activation=cfg.activation)
    return y

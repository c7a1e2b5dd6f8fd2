"""KratosSpec and the packed serving projection (port of `repro.core.kratos`).

A `KratosSpec` attaches to every weight-stationary projection and selects
block sparsity (`impl='tree'` gathers the kept blocks, 'systolic' keeps a
masked dense weight), weight precision `bits`, and the block grid `bk, bn`.
`pack()` turns a dense `{"w": (n_in, n_out)}` leaf into serving buffers;
`apply_packed` picks the GEMM kernel from which buffers `pack()` produced:

    'w'                   -> dense_matmul
    'qt'                  -> quant_matmul, or quant_matmul_w8a8 when
                             act_bits == 8 and the codes are 8-bit
    'blocks'              -> bsr_matmul
    'qblocks' + 'qscale'  -> bsr_quant_matmul

A routed-expert stack `(E, n_in, n_out)` (models.moe) packs through
`pack_experts` into a `PackedExperts`: one block plan shared by every
expert, the experts' kept blocks stacked, run by `apply_experts` as one
expert-batched `bsr_matmul` launch.

Weights keep the JAX layout (n_in, n_out), so the buffers compare one to
one with the JAX package's. The plan's index table becomes an int32 tensor
on the weight's device once, at pack time (`PackedLinear.indices`), never
per call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from repro_torch.core import quantize as qz
from repro_torch.core import sparsity as sp
from repro_torch.kernels import ops

UNROLL_FACTORS = ("pixelwise", "row", "full")


@dataclasses.dataclass(frozen=True)
class KratosSpec:
    sparsity: float = 0.0
    bits: Optional[int] = None
    impl: str = "tree"                # 'tree' | 'systolic'
    unroll: str = "full"
    bk: int = 128
    bn: int = 128
    act_bits: Optional[int] = None    # 8 => w8a8
    seed: int = 0

    def __post_init__(self):
        if self.impl not in ("tree", "systolic"):
            raise ValueError(f"impl must be tree|systolic, got {self.impl}")
        if self.unroll not in UNROLL_FACTORS:
            raise ValueError(f"unroll must be one of {UNROLL_FACTORS}")
        if self.bits is not None and self.bits not in qz.SUPPORTED_BITS:
            raise ValueError(f"bits must be in {qz.SUPPORTED_BITS} or None")
        if self.act_bits not in (None, 8):
            raise ValueError("act_bits must be None or 8")

    @property
    def is_identity(self) -> bool:
        return self.sparsity == 0.0 and self.bits is None and self.act_bits is None

    def with_(self, **kw) -> "KratosSpec":
        return dataclasses.replace(self, **kw)


DENSE = KratosSpec()


def spec_tag(spec: KratosSpec) -> str:
    """Artifact-tag fragment, the same format as the JAX package's."""
    b = "bf16" if spec.bits is None else f"w{spec.bits}"
    if spec.act_bits:
        b += f"a{spec.act_bits}"
    return f"s{spec.sparsity:g}-{b}-{spec.impl}"


@functools.lru_cache(maxsize=4096)
def _plan_cached(n_in: int, n_out: int, bk: int, bn: int,
                 sparsity_milli: int, seed: int) -> sp.BlockSparsePlan:
    return sp.make_plan(n_in, n_out, bk=bk, bn=bn,
                        sparsity=sparsity_milli / 1000.0, seed=seed)


def plan_for(n_in: int, n_out: int,
             spec: KratosSpec) -> Optional[sp.BlockSparsePlan]:
    """The (deterministic, cached) block plan of a projection; None (dense)
    when the spec is dense or the shape does not divide the block grid."""
    if spec.sparsity == 0.0 or n_in % spec.bk or n_out % spec.bn:
        return None
    return _plan_cached(n_in, n_out, spec.bk, spec.bn,
                        int(round(spec.sparsity * 1000)), spec.seed)


def serving_spec(n_in: int, n_out: int, spec: KratosSpec) -> KratosSpec:
    """Degrade an arch-wide spec to what one projection can pack: a k-extent
    that does not divide the values-per-byte keeps float weights."""
    if spec.bits is None:
        return spec
    vpb = qz.VALUES_PER_BYTE[spec.bits]
    tree = spec.impl == "tree" and plan_for(n_in, n_out, spec) is not None
    k_extent = spec.bk if tree else n_in
    if k_extent % vpb:
        spec = spec.with_(bits=None, act_bits=None)
    return spec


def init(n_in: int, n_out: int, spec: KratosSpec = DENSE, *,
         generator: torch.Generator, device, dtype=torch.float32,
         init_scale: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """Dense float master weight, normal * n_in**-0.5; pruned blocks zero.
    Scaled in place, so a large projection never holds two copies."""
    scale = (n_in ** -0.5) if init_scale is None else init_scale
    w = torch.randn((n_in, n_out), generator=generator, device=device,
                    dtype=dtype).mul_(scale)
    plan = plan_for(n_in, n_out, spec)
    if plan is not None:
        w = sp.sparsify_init(w, plan)
    return {"w": w}


def pack(params: Dict[str, torch.Tensor], spec: KratosSpec
         ) -> Dict[str, torch.Tensor]:
    """Convert a dense `{"w"}` leaf into packed inference buffers."""
    w = params["w"]
    n_in, n_out = w.shape
    plan = plan_for(n_in, n_out, spec)
    if plan is None or spec.impl == "systolic":
        if plan is not None:
            w = w * torch.as_tensor(sp.plan_mask(plan), dtype=w.dtype,
                                    device=w.device)
        if spec.bits is None:
            return {"w": w}
        return {"qt": qz.quantize(w, spec.bits)}
    if spec.bits is None:
        return {"blocks": sp.pack_blocks(w, plan)}
    scale = qz.compute_scale(w, spec.bits)                 # (n_out,)
    codes = qz.quantize_values(w, scale, spec.bits)        # int8 dense codes
    cblocks = sp.pack_blocks(codes, plan)                  # (n_pb,nnz,bk,bn)
    n_pb, nnz, bk, bn = cblocks.shape
    vpb = qz.VALUES_PER_BYTE[spec.bits]
    # pack each block along its k axis: move k first, pack, move it back
    flat = cblocks.reshape(n_pb * nnz, bk, bn).transpose(0, 1)
    packed = qz.pack_codes(flat, spec.bits).transpose(0, 1)
    return {"qblocks": packed.reshape(n_pb, nnz, bk // vpb, bn).contiguous(),
            "qscale": scale.to(torch.float32).reshape(n_pb, bn).contiguous()}


@dataclasses.dataclass
class PackedLinear:
    """A projection frozen into packed serving buffers under its pack-time
    spec. `indices` is the plan's int32 index table on the buffers' device
    (None for the dense 'w' buffer)."""

    buffers: Dict[str, object]      # tensors, or a QuantizedTensor at 'qt'
    n_in: int
    n_out: int
    spec: KratosSpec
    indices: Optional[torch.Tensor] = None

    @property
    def packed_bytes(self) -> int:
        return sum(t.packed_bytes if isinstance(t, qz.QuantizedTensor)
                   else t.numel() * t.element_size()
                   for t in self.buffers.values())


def pack_linear(params: Dict[str, torch.Tensor],
                spec: KratosSpec) -> PackedLinear:
    """pack() a `{"w": (n_in, n_out)}` leaf into a PackedLinear."""
    w = params["w"]
    if w.ndim != 2:
        raise ValueError(f"pack_linear expects a 2-D weight, got {tuple(w.shape)}")
    n_in, n_out = int(w.shape[0]), int(w.shape[1])
    spec = serving_spec(n_in, n_out, spec)
    buffers = pack(params, spec)
    indices = None
    if "blocks" in buffers or "qblocks" in buffers:
        indices = torch.as_tensor(plan_for(n_in, n_out, spec).indices,
                                  dtype=torch.int32, device=w.device)
    return PackedLinear(buffers=buffers, n_in=n_in, n_out=n_out, spec=spec,
                        indices=indices)


def apply_packed(p: PackedLinear, x: torch.Tensor) -> torch.Tensor:
    """Inference-time projection on packed buffers: (..., n_in) ->
    (..., n_out); the kernel is keyed on which buffers `pack()` produced."""
    lead = x.shape[:-1]
    xm = x.reshape(-1, p.n_in)
    b = p.buffers
    if "w" in b:
        y = ops.matmul(xm, b["w"].to(x.dtype))
    elif "qt" in b:
        if p.spec.act_bits == 8 and b["qt"].bits == 8:
            y = ops.quant_matmul_w8a8(xm, b["qt"])
        else:
            y = ops.quant_matmul(xm, b["qt"])
    elif "blocks" in b:
        y = ops.bsr_matmul(xm, b["blocks"].to(x.dtype), p.indices)
    else:
        y = ops.bsr_quant_matmul(xm, b["qblocks"], b["qscale"], p.indices,
                                 p.spec.bits)
    return y.reshape(*lead, p.n_out)


@dataclasses.dataclass
class PackedExperts:
    """A routed-expert stack frozen for serving: every expert's kept
    blocks (E, n_pb, nnz, bk, bn) over the one plan all experts share
    (the plan depends on the shape only); `indices` is its int32 index
    table on the blocks' device."""

    blocks: torch.Tensor
    indices: torch.Tensor


def pack_experts(w: torch.Tensor, spec: KratosSpec):
    """Freeze one routed-expert stack w (E, n_in, n_out) for the tree path
    of the JAX package's expert FFN (`models.moe.pack_moe` decides that a
    layer takes it). Each expert's weight is w + (fake_quantize(w) - w)
    when the spec sets bits (the training-time apply's straight-through
    forward), else w; with a plan for this stack's own shape its kept
    blocks form a PackedExperts, without one the float stack stays for a
    dense product, as the reference's apply does."""
    e, n_in, n_out = (int(v) for v in w.shape)
    plan = plan_for(n_in, n_out, spec)
    if spec.bits is None and plan is None:
        return w
    out = torch.empty((e, plan.n_pb, plan.nnz, plan.bk, plan.bn)
                      if plan is not None else (e, n_in, n_out),
                      dtype=w.dtype, device=w.device)
    for i in range(e):
        we = w[i]
        if spec.bits is not None:
            we = we + (qz.fake_quantize(we, spec.bits) - we)
        out[i] = we if plan is None else sp.pack_blocks(we, plan)
    if plan is None:
        return out
    return PackedExperts(blocks=out, indices=torch.as_tensor(
        plan.indices, dtype=torch.int32, device=w.device))


def apply_experts(p, x: torch.Tensor) -> torch.Tensor:
    """Every expert's projection at once: x (E, M, n_in) -> (E, M, n_out).
    A PackedExperts runs the expert-batched block-sparse kernel (one
    launch); a float stack is a batched plain product (the reference's
    einsum, outside any kernel)."""
    if isinstance(p, PackedExperts):
        return ops.bsr_matmul_experts(x, p.blocks.to(x.dtype), p.indices)
    return torch.bmm(x, p.to(x.dtype))


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W for a PackedLinear leaf. A dense `{"w"}` training leaf
    (the JAX package's fake-quant / masked training apply) has no port yet."""
    if not isinstance(params, PackedLinear):
        raise NotImplementedError(
            "the training-time Kratos apply is not ported yet (ROADMAP.md "
            "queue 1, item 9): pack the model first "
            "(serve.registry.pack_model_params)")
    return apply_packed(params, x)


def cost_report(n_in: int, n_out: int, spec: KratosSpec, m: int = 1,
                act_bytes: int = 2) -> Dict[str, float]:
    """Analytic effective cost of one application (the paper's area report
    restated as MACs and weight bytes); same numbers as the JAX package's."""
    dense_macs = m * n_in * n_out
    plan = plan_for(n_in, n_out, spec)
    keep = 1.0 if plan is None else plan.dense_flops_fraction
    macs = dense_macs * (keep if spec.impl == "tree" else 1.0)
    wbits = 16 if spec.bits is None else spec.bits
    weight_bytes = n_in * n_out * wbits / 8.0
    if spec.impl == "tree":
        weight_bytes *= keep
    mxu_rate = 2.0 if (spec.act_bits == 8 and spec.bits == 8) else 1.0
    return {
        "dense_macs": float(dense_macs),
        "effective_macs": float(macs),
        "mac_fraction": float(macs / dense_macs),
        "weight_bytes": float(weight_bytes),
        "weight_bytes_fraction": float(weight_bytes / (2.0 * n_in * n_out)),
        "mxu_rate": mxu_rate,
        "equiv_compute_time_fraction": float(macs / dense_macs / mxu_rate),
    }

"""The assigned (architecture x input-shape) grid: 10 archs x 4 shapes (port
of `repro.launch.shapes`).

Defines, per cell:
  * the step the dry-run counts (the train step, a prefill or the legacy
    one-token decode), on the plain path (`kernels.ops.reference_path`,
    the counterpart of the JAX package's `backend="ref"`);
  * `cell_inputs()`: meta tensors (shapes and dtypes, nothing allocated;
    the JAX package's ShapeDtypeStructs) for every step input: params,
    optimizer state, batches, KV caches, made by the port's own init and
    cache functions on `device="meta"`;
  * applicability (long_500k runs only where the KV state is bounded or
    sub-quadratic);
  * the per-arch dry-run policy (grad-accumulation factor and dtypes), the
    JAX package's, name for name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs as C
from repro_torch.distributed import steps as ST
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O

META = "meta"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# long_500k runs only where the per-layer KV state is bounded (SWA circular
# cache) or O(1) (SSM); pure full-attention archs are skipped per the brief.
LONG_OK = {
    "falcon_mamba_7b": "O(1) SSM state",
    "jamba_v0_1_52b": "SSM + 1:8 attn layers (the few full caches shard and fit)",
    "h2o_danube_1_8b": "SWA: cache capped at window=4096",
    "llava_next_mistral_7b": "Mistral SWA: cache capped at window=4096",
    "gemma2_27b": "alternating local/global: half the caches are window-capped,"
                  " the 23 global 500k caches shard over the mesh and fit",
}
LONG_SKIP_REASON = ("pure full-attention: every layer needs an unbounded "
                    "O(S) cache and O(S^2) prefill; skipped per brief")


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    arch = C.ALIASES.get(arch, arch)
    if shape == "long_500k":
        if arch not in LONG_OK:
            return False, LONG_SKIP_REASON
        return True, LONG_OK[arch]
    return True, ""


# ---------------------------------------------------------------------------
# Per-arch dry-run policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DryrunPolicy:
    grad_accum: int = 4              # train_4k microbatching
    opt_state_dtype: str = "float32"
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"
    accum_dtype: str = "float32"     # grad-accumulation buffer
    remat_policy: str = "nothing"


POLICIES: Dict[str, DryrunPolicy] = {
    "minicpm3_4b": DryrunPolicy(grad_accum=4),
    "nemotron_4_340b": DryrunPolicy(grad_accum=4, opt_state_dtype="bfloat16",
                                    accum_dtype="bfloat16"),
    "gemma2_27b": DryrunPolicy(grad_accum=8),
    "h2o_danube_1_8b": DryrunPolicy(grad_accum=2),
    "jamba_v0_1_52b": DryrunPolicy(grad_accum=8),
    "whisper_large_v3": DryrunPolicy(grad_accum=2),
    "deepseek_v2_lite_16b": DryrunPolicy(grad_accum=4),
    "deepseek_moe_16b": DryrunPolicy(grad_accum=4),
    "llava_next_mistral_7b": DryrunPolicy(grad_accum=8),
    "falcon_mamba_7b": DryrunPolicy(grad_accum=8),
}


def policy_for(arch: str) -> DryrunPolicy:
    return POLICIES[C.ALIASES.get(arch, arch)]


def config_for_dryrun(arch: str, **overrides) -> T.ModelConfig:
    """Full published config with dry-run dtypes applied."""
    pol = policy_for(arch)
    cfg = C.get_config(arch)
    return dataclasses.replace(
        cfg, param_dtype=pol.param_dtype, dtype=pol.act_dtype,
        remat=True, remat_policy=pol.remat_policy, **overrides)


# ---------------------------------------------------------------------------
# Meta-tensor inputs (never allocate)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: T.ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    b, s = cell.batch, cell.seq
    out = {"tokens": _meta((b, s), torch.int32),
           "labels": _meta((b, s), torch.int32)}
    if cfg.enc_dec:
        out["frames"] = _meta((b, cfg.enc_positions, cfg.d_model),
                              torch.float32)
    if cfg.n_img_tokens:
        out["img_embeds"] = _meta((b, cfg.n_img_tokens, cfg.d_model),
                                  torch.float32)
    return out


def state_specs(cfg: T.ModelConfig, opt_cfg: O.OptimizerConfig):
    """The training state (params + AdamW m/v + step) on the meta device."""
    return ST.init_train_state(0, cfg, opt_cfg, device=META)


def param_specs(cfg: T.ModelConfig):
    """The parameters on the meta device. An encoder-decoder keeps its
    position table, which the port's serving steps read as a buffer (the
    JAX package computes it in the forward)."""
    return T.init(cfg, device=META)


def cache_specs(cfg: T.ModelConfig, batch: int, max_len: int, dtype):
    return T.make_caches(cfg, batch, max_len, dtype, META)


def cell_inputs(arch: str, cell: ShapeCell, cfg: Optional[T.ModelConfig] = None,
                opt_cfg: Optional[O.OptimizerConfig] = None):
    """Returns (step_kind, args tuple of meta tensors) for the cell."""
    pol = policy_for(arch)
    cfg = cfg or config_for_dryrun(arch)
    if cell.kind == "train":
        opt_cfg = opt_cfg or O.OptimizerConfig(state_dtype=pol.opt_state_dtype)
        state = state_specs(cfg, opt_cfg)
        batch = batch_specs(cfg, cell)
        return "train", (state, batch)
    params = param_specs(cfg)
    cdtype = getattr(torch, pol.cache_dtype)
    if cell.kind == "prefill":
        max_len = cell.seq + cfg.n_img_tokens
        caches = cache_specs(cfg, cell.batch, max_len, cdtype)
        batch = batch_specs(cfg, cell)
        del batch["labels"]
        return "prefill", (params, batch, caches)
    # decode: one new token against a cache holding `seq` positions
    max_len = cell.seq + cfg.n_img_tokens
    caches = cache_specs(cfg, cell.batch, max_len, cdtype)
    token = _meta((cell.batch, 1), torch.int32)
    index = _meta((), torch.int32)
    return "decode", (params, caches, token, index)


def _plain(step):
    """A serving step on the plain path without autograd (the JAX
    package's `backend="ref"` under jit)."""
    def run(*args):
        with ops.reference_path(), torch.no_grad():
            return step(*args)
    return run


def make_step_fn(arch: str, cell: ShapeCell, cfg: Optional[T.ModelConfig] = None,
                 opt_cfg: Optional[O.OptimizerConfig] = None, *,
                 mesh_dp: int = 16, mesh=None):
    """The callable the dry-run counts for this cell. mesh: the train
    step's data parallelism (its gradients are averaged over 'data' and
    'pod'); the serving steps read the mesh `use_mesh` installs."""
    pol = policy_for(arch)
    cfg = cfg or config_for_dryrun(arch)
    if cell.kind == "train":
        opt_cfg = opt_cfg or O.OptimizerConfig(state_dtype=pol.opt_state_dtype)
        # keep >= 1 batch row per data shard in each microbatch
        ga = max(1, min(pol.grad_accum, cell.batch // max(mesh_dp, 1)))
        return ST.make_train_step(cfg, opt_cfg, grad_accum=ga,
                                  accum_dtype=getattr(torch, pol.accum_dtype),
                                  mesh=mesh)
    if cell.kind == "prefill":
        return _plain(ST.make_prefill_step(cfg))
    return _plain(ST.make_decode_step(cfg))

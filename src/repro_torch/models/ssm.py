"""Mamba-1 selective state-space mixer (port of `repro.models.ssm`, the
falcon-mamba form).

The recurrence  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t h_t
+ D x_t  runs two ways:

  * prefill / full sequence: `kernels.ops.ssm_scan` — the hand-written
    selective-scan kernel on the card (any S, any d_inner), its plain
    version on the CPU. The (B, S, d_inner, d_state) decay and update
    tensors are never built; the JAX package's chunked associative scan
    (`_scan_chunked`) only bounded XLA's copy of them and has no
    counterpart here. The training step's forward (on
    `kernels.ops.reference_path`) runs the plain sequential scan
    (`kernels.ref.ssm_scan_ref`) instead, which autograd differentiates.
  * decode (S == 1): the single-step recurrence in plain torch ops, as the
    JAX package has it outside any kernel, on a (B, d_inner, d_state) f32
    state and a (B, d_conv - 1, d_inner) conv tail. Nothing is read back
    to the host.

Caches are updated IN PLACE (the JAX package returns new arrays): decode
advances every slot's tail and state, prefill writes the final state and
the prompt's last d_conv - 1 inputs. Under a mesh whose 'model' axis
splits a decode cache's d_inner channels (distributed.sharding.use_mesh),
a rank runs the conv and the recurrence of its channels, all-gathering
the activations for x_proj and the output before out_proj. falcon-mamba
adds RMSNorm on the (B, C, dt) streams (`bcdt_rms`). The in/x/out
projections go through `core.kratos`; `dt_proj` stays a plain matmul, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import kratos as kr
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)
    bcdt_rms: bool = False      # falcon-mamba

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def mamba_init(cfg: MambaConfig, spec: kr.KratosSpec = kr.DENSE, *,
               generator: torch.Generator, device, dtype=torch.float32
               ) -> Dict:
    """Random parameters from `generator` (the JAX package's init laws;
    other numbers)."""
    d, di, st, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    kw = dict(generator=generator, device=device, dtype=dtype)
    ones = lambda n: torch.ones(n, dtype=dtype, device=device)
    p = {
        "in_proj": kr.init(d, 2 * di, spec, **kw),
        "conv_w": torch.randn((cfg.d_conv, di), **kw).mul_(0.2),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": kr.init(di, r + 2 * st, spec, **kw),
        "dt_proj": {"w": torch.randn((r, di), **kw).mul_(r ** -0.5),
                    "b": torch.full((di,), math.log(math.expm1(0.01)),
                                    dtype=dtype, device=device)},
        "A_log": torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                        device=device)).repeat(di, 1),
        "D": ones(di),
        "out_proj": kr.init(di, d, spec, **kw),
    }
    if cfg.bcdt_rms:
        p["b_norm"] = {"scale": ones(st)}
        p["c_norm"] = {"scale": ones(st)}
        p["dt_norm"] = {"scale": ones(r)}
    return p


def _depthwise_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv1d. u: (B, S, di); w: (K, di); tail:
    (B, K-1, di) inputs before u (zeros when None)."""
    k = w.shape[0]
    pad = tail if tail is not None else u.new_zeros(
        (u.shape[0], k - 1, u.shape[2]))
    up = torch.cat([pad, u], dim=1)                         # (B, S+K-1, di)
    out = sum(up[:, i:i + u.shape[1]] * w[i] for i in range(k))
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) everywhere, like `jax.nn.softplus` (torch's
    `F.softplus` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_params(params, u, cfg: MambaConfig, spec: kr.KratosSpec):
    """u: (B, S, di) -> dt (B, S, di), B_ (B, S, st), C_ (B, S, st)."""
    st, r = cfg.d_state, cfg.rank
    xdbc = kr.apply(params["x_proj"], u, spec)
    dt_in, b_, c_ = torch.split(xdbc, [r, st, st], dim=-1)
    if cfg.bcdt_rms:
        dt_in = L.rmsnorm(params["dt_norm"], dt_in)
        b_ = L.rmsnorm(params["b_norm"], b_)
        c_ = L.rmsnorm(params["c_norm"], c_)
    dt = _softplus(torch.matmul(dt_in, params["dt_proj"]["w"].to(u.dtype))
                   + params["dt_proj"]["b"].to(u.dtype))
    return dt, b_, c_


def mamba_apply(params, x: torch.Tensor, cfg: MambaConfig, *,
                cache: Optional[Dict] = None, index=None,
                spec: kr.KratosSpec = kr.DENSE,
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d). cache: {'conv': (B, K-1, di), 'ssm': (B, di, st)}.
    index None runs the sequence from a zero state (writing `cache` when
    given: prefill); otherwise one decode step (S == 1) from `cache`. The
    cache is updated in place and returned. spec: the model's Kratos spec,
    for the training-time apply of dense leaves."""
    bsz, s, _ = x.shape
    k1 = cfg.d_conv - 1
    ug = kr.apply(params["in_proj"], x, spec)
    u, gate = ug.chunk(2, dim=-1)                           # (B, S, di) each
    decode = cache is not None and index is not None
    # under a mesh whose 'model' axis splits the cache's channels, this
    # rank runs its channels `ch`: their conv and recurrence, the
    # activations all-gathered for x_proj and before out_proj
    ch, group = slice(None), None
    if decode and cache["ssm"].shape[1] != cfg.d_inner:
        r, group = SH.model_shard()
        dl = cache["ssm"].shape[1]
        ch = slice(r * dl, (r + 1) * dl)
        u, gate = u[..., ch], gate[..., ch]
    u_conv = _depthwise_conv(u, params["conv_w"][:, ch].to(u.dtype),
                             params["conv_b"][ch].to(u.dtype),
                             cache["conv"] if decode else None)
    u_act = F.silu(u_conv)
    dt, b_, c_ = _ssm_params(params,
                             SH.all_gather_axis(u_act, -1, group), cfg, spec)
    a = -torch.exp(params["A_log"][ch].float())             # (di, st)

    if decode:
        if s != 1:
            raise ValueError(f"mamba decode takes one token, got S={s}")
        dtf = dt[:, 0, ch].float()
        da = torch.exp(dtf[..., None] * a)                  # (B, di, st)
        dbx = (dtf * u_act[:, 0].float())[..., None] \
            * b_[:, 0].float()[:, None, :]
        h = da * cache["ssm"] + dbx
        if k1:
            cache["conv"].copy_(torch.cat([cache["conv"][:, 1:], u[:, :1]],
                                          dim=1))
        cache["ssm"].copy_(h)
        y = torch.einsum("bds,bs->bd", h, c_[:, 0].float())[:, None]
    else:
        scan = ref.ssm_scan_ref if ops.on_reference_path() else ops.ssm_scan
        y, h_last = scan(u_act.float(), dt.float(), b_.float(), c_.float(), a)
        if cache is not None:       # prefill: final state + conv tail
            if k1:
                tail = u[:, -k1:]
                if s < k1:          # a prompt shorter than the tail
                    tail = torch.cat([u.new_zeros((bsz, k1 - s, u.shape[2])),
                                      tail], dim=1)
                cache["conv"].copy_(tail)
            cache["ssm"].copy_(h_last)
    y = y.to(x.dtype) + u_act * params["D"][ch].to(x.dtype)
    y = SH.all_gather_axis(y * F.silu(gate), -1, group)
    return kr.apply(params["out_proj"], y, spec), cache


def make_mamba_cache(cfg: MambaConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=dtype,
                           device=device),
    }

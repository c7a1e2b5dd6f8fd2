"""Kratos convolutions (conv1d / conv2d) through im2col onto the Kratos
GEMMs (port of `repro.core.conv`).

The paper's convolutions feed a fully-unrolled filter through an
input-staging network. Here the staging network is im2col patch
extraction (plain data movement) and the unrolled filter a Kratos GEMM
over the (Fw*Fh*Ic, Oc) weight, so filter sparsity and precision get the
treatment GEMM weights get. The unroll factor (pixelwise / row / full)
drives the benchmark's throughput accounting only; execution always runs
the whole im2col at once.

The concat order is the JAX package's (fw outer, fh inner, ic last), so a
weight carried from JAX means the same filter here. `params["w"]` is a
dense `{"w"}` leaf's weight, which runs the training-time `kratos.apply`
(on `kernels.ops.reference_path()` only), or a `PackedLinear`, which runs
`apply_packed` on the hand-written kernels (their plain versions for CPU
tensors). Params carry the int `fw` (and `fh`). `conv1d_ref` /
`conv2d_ref` are `torch.nn.functional` convolutions, an oracle only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import kratos as kr


def im2col_1d(x: torch.Tensor, fw: int) -> torch.Tensor:
    """x: (B, Iw, Ic) -> patches (B, Ow, Fw*Ic); stride 1, no padding."""
    b, iw, ic = x.shape
    ow = iw - fw + 1
    cols = [x[:, i:i + ow, :] for i in range(fw)]
    return torch.cat(cols, dim=-1).reshape(b, ow, fw * ic)


def im2col_2d(x: torch.Tensor, fw: int, fh: int) -> torch.Tensor:
    """x: (B, Iw, Ih, Ic) -> patches (B, Ow, Oh, Fw*Fh*Ic); stride 1, valid."""
    b, iw, ih, ic = x.shape
    ow, oh = iw - fw + 1, ih - fh + 1
    cols = [x[:, di:di + ow, dj:dj + oh, :]
            for di in range(fw) for dj in range(fh)]
    return torch.cat(cols, dim=-1).reshape(b, ow, oh, fw * fh * ic)


def conv_weight_as_gemm(w: torch.Tensor) -> torch.Tensor:
    """(Fw, Fh, Ic, Oc) or (Fw, Ic, Oc) filter -> (Fw*[Fh*]Ic, Oc) GEMM
    weight, in the im2col concat order."""
    return w.reshape(-1, w.shape[-1])


def _gemm(w, patches: torch.Tensor, spec: kr.KratosSpec) -> torch.Tensor:
    return kr.apply(w if isinstance(w, kr.PackedLinear) else {"w": w},
                    patches, spec)


def conv1d(params: Dict, x: torch.Tensor,
           spec: kr.KratosSpec = kr.DENSE) -> torch.Tensor:
    """params['w']: (Fw*Ic, Oc) GEMM-form filter or its PackedLinear;
    params['fw']; x: (B, Iw, Ic) -> (B, Ow, Oc)."""
    fw = params.get("fw")
    if fw is None:
        raise ValueError("conv1d params must carry 'fw'")
    return _gemm(params["w"], im2col_1d(x, fw), spec)


def conv2d(params: Dict, x: torch.Tensor,
           spec: kr.KratosSpec = kr.DENSE) -> torch.Tensor:
    """params['w']: (Fw*Fh*Ic, Oc) or its PackedLinear; params['fw'],
    params['fh']; x: (B, Iw, Ih, Ic) -> (B, Ow, Oh, Oc)."""
    return _gemm(params["w"], im2col_2d(x, params["fw"], params["fh"]), spec)


def conv1d_init(fw: int, ic: int, oc: int, spec: kr.KratosSpec = kr.DENSE,
                *, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict:
    p = kr.init(fw * ic, oc, spec, generator=generator, device=device,
                dtype=dtype)
    p["fw"] = fw
    return p


def conv2d_init(fw: int, fh: int, ic: int, oc: int,
                spec: kr.KratosSpec = kr.DENSE, *,
                generator: torch.Generator, device,
                dtype=torch.float32) -> Dict:
    p = kr.init(fw * fh * ic, oc, spec, generator=generator, device=device,
                dtype=dtype)
    p["fw"], p["fh"] = fw, fh
    return p


def conv_params(tree: Dict, *, device) -> Dict:
    """Params carried from the JAX package (a `{"w"}` leaf as a numpy or
    array-like value, the int `fw` / `fh` where present) as the port's:
    the weight a float32 tensor on `device`, the filter sizes ints."""
    out = {"w": torch.as_tensor(np.array(tree["w"], dtype=np.float32),
                            device=device)}
    for k in ("fw", "fh"):
        if k in tree:
            out[k] = int(tree[k])
    return out


def conv1d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Ground-truth conv1d through F.conv1d (w: (Fw, Ic, Oc))."""
    out = F.conv1d(x.permute(0, 2, 1), w.permute(2, 1, 0))
    return out.permute(0, 2, 1)                    # (B, Ow, Oc)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Ground-truth conv2d through F.conv2d (w: (Fw, Fh, Ic, Oc); x:
    (B, Iw, Ih, Ic))."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1)                 # (B, Ow, Oh, Oc)

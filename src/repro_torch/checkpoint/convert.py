"""Carry JAX parameters across to the port.

Reads the flat path -> array dict that `repro.checkpoint.manager.
save_pytree` writes (`<dir>/arrays.npz`), or the same dict in memory, and
returns the port's parameter tree (`models.transformer`): the JAX
package's layer-stacked `blocks/#s/...` arrays (leading layer axis, scan
slot s) are unstacked into the per-layer list, layer `prelude + t *
period + s` taking row t (gemma2's two slots interleave local and global
layers). Weights keep their (n_in, n_out) layout. An MoE layer's
`ffn/router/w`, its raw routed-expert stacks `ffn/w_gate` / `w_up` /
`w_down` ((E, d, f) per layer, no `/w` suffix) and its shared experts
`ffn/shared/<proj>/w` carry across as they are. A layer parameter the
port's families do not have (a cross-attention), and a checkpoint whose
layers mix Mamba and attention mixers (the jamba hybrid), are refused.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch


def read_flat(src: Union[str, Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The flat path -> array dict, from a save_pytree directory or a dict."""
    if isinstance(src, Mapping):
        return {k: np.asarray(v) for k, v in src.items()}
    with np.load(os.path.join(src, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


# per-layer parameter names of the ported families: the (sandwich) norms,
# the GQA and MLA mixers, the Mamba mixer, the MLP and the MoE FFN
_LAYER_MODULES = frozenset({"pre_norm", "post_norm", "mixer", "ffn_norm",
                            "ffn_post_norm", "ffn"})
_MEMBERS = frozenset({
    "scale", "bias",
    "wq", "wk", "wv", "wo", "q_norm", "k_norm",
    "wq_a", "wq_b", "wkv_a", "kv_norm", "wkv_b",
    "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "A_log", "D",
    "out_proj", "b_norm", "c_norm", "dt_norm",
    "w_gate", "w_up", "w_down"})
# an MoE FFN's router and shared experts (a gated MLP)
_MOE_MEMBERS = {"router": frozenset({"w"}),
                "shared": frozenset({"w_gate", "w_up", "w_down"})}


def _unported(key: str) -> NotImplementedError:
    return NotImplementedError(
        f"parameter '{key}' belongs to a model family the port does not "
        "have yet (ROADMAP.md queue 1, item 7)")


def _layer_path(key: str, path):
    if path[0] not in _LAYER_MODULES:
        raise _unported(key)
    if path[0] == "ffn" and path[1] in _MOE_MEMBERS:
        if len(path) < 3 or path[2] not in _MOE_MEMBERS[path[1]]:
            raise _unported(key)
    elif path[1] not in _MEMBERS:
        raise _unported(key)
    return path


def _put(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def convert(src: Union[str, Mapping[str, np.ndarray]], n_layers: int, *,
            device="cpu") -> Dict[str, Any]:
    """JAX flat params -> the port's params, as tensors on `device`."""
    flat = read_flat(src)
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prelude = {int(k.split("/")[1].lstrip("#")) for k in flat
               if k.startswith("prelude/")}
    slots = {int(k.split("/")[1].lstrip("#")) for k in flat
             if k.startswith("blocks/")}
    n_prelude, period = len(prelude), len(slots)
    layers = [{} for _ in range(n_layers)]
    params: Dict[str, Any] = {"layers": layers}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "prelude":
            _put(layers[int(parts[1].lstrip("#"))], _layer_path(key, parts[2:]),
                 tensor(arr))
        elif parts[0] == "blocks":
            s = int(parts[1].lstrip("#"))
            path = _layer_path(key, parts[2:])
            for t in range(arr.shape[0]):
                _put(layers[n_prelude + t * period + s], path,
                     tensor(arr[t]))
        elif parts[0] in ("embed", "final_norm", "head"):
            _put(params, parts, tensor(arr))
        else:
            raise _unported(key)
    if any(not lp for lp in layers):
        raise ValueError(f"checkpoint does not fill all {n_layers} layers")
    mamba = ["in_proj" in lp["mixer"] for lp in layers]
    if any(mamba) and not all(mamba):
        raise NotImplementedError(
            "checkpoint mixes Mamba and attention mixers (the jamba hybrid), "
            "which the port does not have yet (ROADMAP.md queue 1, item 7)")
    return params

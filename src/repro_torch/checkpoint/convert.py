"""Carry JAX parameters across to the port.

Reads the flat path -> array dict that `repro.checkpoint.manager.
save_pytree` writes (`<dir>/arrays.npz`), or the same dict in memory, and
returns the port's parameter tree (`models.transformer`): the JAX
package's layer-stacked `blocks/#s/...` arrays (leading layer axis, scan
slot s) are unstacked into the per-layer list, layer `prelude + t *
period + s` taking row t. Weights keep their (n_in, n_out) layout.
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
            _put(layers[int(parts[1].lstrip("#"))], parts[2:], tensor(arr))
        elif parts[0] == "blocks":
            s = int(parts[1].lstrip("#"))
            for t in range(arr.shape[0]):
                _put(layers[n_prelude + t * period + s], parts[2:],
                     tensor(arr[t]))
        elif parts[0] in ("embed", "final_norm", "head"):
            _put(params, parts, tensor(arr))
        else:
            raise NotImplementedError(
                f"parameter '{key}' belongs to a model family the port does "
                "not have yet (ROADMAP.md queue 1, item 7)")
    if any(not lp for lp in layers):
        raise ValueError(f"checkpoint does not fill all {n_layers} layers")
    return params

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
`ffn/shared/<proj>/w` carry across as they are. The jamba hybrid's
slots mix Mamba and attention mixers (its 8 slots, one Jamba block each
period, unstack like any other). The encoder-decoder (whisper) adds a
decoder layer's `cross/{wq,wk,wv,wo}/w` and `cross_norm`, the encoder's
stacked `enc_blocks/...` (layer axis first, no slot index), unstacked into
`enc_layers`, and `enc_norm`. A key no family of the port has is refused.

`to_reference` is the inverse: the port's per-layer tree back to the JAX
package's stacked slots (`prelude/#i/...`, `blocks/#s/...` with the
leading layer axis, `enc_blocks/...`), which `checkpoint.manager` writes
in the JAX package's own layout; `convert_state` and `state_to_reference`
carry a whole train state ({"params", "opt": {"m", "v", "count"},
"step", "comp"?}) each way, AdamW's m / v and the error-feedback
residuals laid out like the parameters. Whisper's position table is no
parameter of the JAX package: it is in no checkpoint and is dropped.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Union

import numpy as np
import torch

from repro_torch import tree as tu


def read_flat(src: Union[str, Mapping[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The flat path -> array dict, from a save_pytree directory or a dict.
    A dict's arrays are copied: the port trains its tensors in place, and
    the caller's arrays (a JAX state's buffers among them) stay as they
    are."""
    if isinstance(src, Mapping):
        return {k: np.array(v) for k, v in src.items()}
    with np.load(os.path.join(src, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


# per-layer parameter names of the ported families: the (sandwich) norms,
# the GQA and MLA mixers, the Mamba mixer, the MLP and the MoE FFN, and a
# decoder layer's cross-attention and its norm
_LAYER_MODULES = frozenset({"pre_norm", "post_norm", "mixer", "ffn_norm",
                            "ffn_post_norm", "ffn", "cross_norm", "cross"})
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


def _unknown(key: str) -> ValueError:
    return ValueError(f"parameter '{key}' belongs to no model family of "
                      "the port")


def _layer_path(key: str, path):
    if path[0] not in _LAYER_MODULES:
        raise _unknown(key)
    if path[0] == "ffn" and path[1] in _MOE_MEMBERS:
        if len(path) < 3 or path[2] not in _MOE_MEMBERS[path[1]]:
            raise _unknown(key)
    elif path[1] not in _MEMBERS:
        raise _unknown(key)
    return path


def _put(tree: Dict[str, Any], path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def convert(src: Union[str, Mapping[str, np.ndarray]], n_layers: int, *,
            device="cpu") -> Dict[str, Any]:
    """JAX flat params -> the port's params, as tensors on `device`."""
    return _convert(read_flat(src), n_layers, device)


def _convert(flat: Dict[str, np.ndarray], n_layers: int, device
             ) -> Dict[str, Any]:
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    prelude = {int(k.split("/")[1].lstrip("#")) for k in flat
               if k.startswith("prelude/")}
    slots = {int(k.split("/")[1].lstrip("#")) for k in flat
             if k.startswith("blocks/")}
    n_prelude, period = len(prelude), len(slots)
    layers = [{} for _ in range(n_layers)]
    params: Dict[str, Any] = {"layers": layers}
    enc_layers = []
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
        elif parts[0] == "enc_blocks":
            path = _layer_path(key, parts[1:])
            for t in range(arr.shape[0]):
                if t == len(enc_layers):
                    enc_layers.append({})
                _put(enc_layers[t], path, tensor(arr[t]))
        elif parts[0] in ("embed", "final_norm", "head", "enc_norm"):
            _put(params, parts, tensor(arr))
        else:
            raise _unknown(key)
    if any(not lp for lp in layers):
        raise ValueError(f"checkpoint does not fill all {n_layers} layers")
    if enc_layers:
        params["enc_layers"] = enc_layers
    return params


def reference_layers(cfg) -> List[int]:
    """The layers that head a leaf of the JAX package's layer-stacked
    trees: each prelude layer, and the first layer of each scan slot (the
    slot's later layers are rows of the same leaf)."""
    n0 = cfg.prelude_layers
    return [*range(n0), *range(n0, min(n0 + cfg.scan_period, cfg.n_layers))]


def to_reference(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The port's params (or a tree laid out like them: AdamW's m / v, the
    compression residuals) -> the JAX package's tree: layers stacked per
    scan slot (layer prelude + t * period + s is row t of `blocks[s]`) on
    their device, the prelude a list, the encoder's layers stacked into
    `enc_blocks`; `pos_table` is dropped. Stacked leaves are new tensors
    (numpy arrays where the tree's leaves are numpy: a host snapshot);
    the others are the tree's own."""
    n0, period = cfg.prelude_layers, cfg.scan_period
    layers: List[Dict[str, Any]] = params["layers"]
    out = {k: v for k, v in params.items()
           if k not in ("layers", "enc_layers", "pos_table")}
    out["prelude"] = list(layers[:n0])
    out["blocks"] = [_stack(layers[n0 + s::period])
                     for s in range(period)]
    if "enc_layers" in params:
        out["enc_blocks"] = _stack(params["enc_layers"])
    return out


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    return tu.tree_map(lambda *xs: np.stack(xs)
                       if isinstance(xs[0], np.ndarray) else torch.stack(xs),
                       trees[0], *trees[1:])


def state_to_reference(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A port train state -> the JAX package's train-state tree."""
    out = {"params": to_reference(state["params"], cfg),
           "opt": {"m": to_reference(state["opt"]["m"], cfg),
                   "v": to_reference(state["opt"]["v"], cfg),
                   "count": state["opt"]["count"]},
           "step": state["step"]}
    if state.get("comp") is not None:
        out["comp"] = to_reference(state["comp"], cfg)
    return out


def convert_state(src: Union[str, Mapping[str, np.ndarray]], cfg, *,
                  device="cpu") -> Dict[str, Any]:
    """The JAX package's flat train state (a save_pytree directory or its
    path -> array dict: `params/...`, `opt/m/...`, `opt/v/...`,
    `opt/count`, `step`, `comp/...`) -> the port's train state on
    `device`."""
    return state_from_flat(read_flat(src), cfg, device)


def state_from_flat(flat: Dict[str, np.ndarray], cfg, device
                    ) -> Dict[str, Any]:
    """`convert_state` of a flat dict whose arrays the port may own (a
    restore's fresh arrays): no copy on the CPU."""
    def part(prefix: str) -> Dict[str, Any]:
        sub = {k[len(prefix):]: v for k, v in flat.items()
               if k.startswith(prefix)}
        return _convert(sub, cfg.n_layers, device)

    scalar = lambda k: torch.as_tensor(np.asarray(flat[k]),
                                       dtype=torch.int32, device=device)
    state = {"params": part("params/"),
             "opt": {"m": part("opt/m/"), "v": part("opt/v/"),
                     "count": scalar("opt/count")},
             "step": scalar("step")}
    if any(k.startswith("comp/") for k in flat):
        state["comp"] = part("comp/")
    return state

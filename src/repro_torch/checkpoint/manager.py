"""Atomic, async-capable checkpoints in the JAX package's format (port of
`repro.checkpoint.manager`).

  * Format: one `arrays.npz` of the flattened tree (a leaf's key is its
    path: dict keys, `#i` for list items, joined by '/') and a
    `manifest.json` ({"keys", "metadata"}), byte for byte the layout
    `repro.checkpoint.manager.save_pytree` writes. A bf16 leaf is stored
    as f32 (numpy has no bf16); a restore casts it back to the like
    tree's dtype. A port train state is copied to the host leaf by leaf
    and restacked there by `checkpoint.convert.state_to_reference`
    (`save_train_state`), so the JAX package's
    `load_pytree(path, like=jax_state)` reads it, and
    `convert.convert_state` reads the JAX package's.
  * Atomic: a checkpoint is written to `<dir>/tmp-<step>` and renamed to
    `<dir>/step-<step>`; `latest_step()` sees only renamed directories
    with a manifest, and garbage collection drops orphaned `tmp-*`
    directories of crashed writers.
  * Async: `save(..., blocking=False)` snapshots every leaf to host
    memory by copying (a CPU tensor's `.numpy()` shares the memory the
    next step updates in place) before it returns, then writes on a
    background thread; `wait()` joins it (and runs before the next save).
  * Retention: the last `keep` checkpoints stay.

Restoring onto another device layout (`shardings=`) is multi-device work
(ROADMAP.md queue 1, item 11) and raises NotImplementedError.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.checkpoint import convert as CV


def _refuse_shardings(shardings) -> None:
    if shardings is not None:
        raise NotImplementedError(
            "restoring with shardings= re-meshes across devices: "
            "ROADMAP.md queue 1, item 11 (multi-device)")


def _host(x, copy: bool) -> np.ndarray:
    """A leaf as a host array; a copy of the leaf's memory with `copy`."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=copy).numpy()
    return np.array(x, copy=copy) if copy else np.asarray(x)


def save_pytree(path: str, tree, metadata: Optional[Dict] = None) -> None:
    arrays = {k: _host(v, copy=False)
              for k, v in tu.flatten_with_paths(tree).items()}
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"keys": sorted(arrays.keys()),
                   "metadata": metadata or {}}, f)


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        dev = "cpu" if leaf.device.type == "meta" else leaf.device
        return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return arr.astype(leaf.dtype)
    return arr


def load_pytree(path: str, like, shardings=None):
    """Restore into the structure of `like`: each leaf in like's type,
    dtype and device (a tensor on the 'meta' device, which lends only its
    shape and dtype, comes back on the CPU)."""
    _refuse_shardings(shardings)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    out = []
    for key, leaf in tu.items(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        out.append(_like(arrays[key], leaf))
    return tu.unflatten(like, out)


def load_metadata(path: str) -> Dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("metadata", {})


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step-(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step-{step}")

    def save(self, step: int, tree, metadata: Optional[Dict] = None,
             blocking: bool = True, layout=None) -> None:
        """Snapshot `tree` to host memory (a copy of every leaf), then
        write it, on a background thread unless `blocking`. `layout`, if
        given, maps the host snapshot to the tree that is written, on the
        writer's thread (a train state's restacking into the JAX
        package's layout: no second device copy, no device pass)."""
        self.wait()
        # the snapshot copies now, so training can update its tensors
        host = tu.tree_map(lambda x: _host(x, copy=True), tree)

        def write():
            tmp = os.path.join(self.dir, f"tmp-{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            out = host if layout is None else layout(host)
            save_pytree(tmp, out, dict(metadata or {}, step=step,
                                       time=time.time()))
            final = self.path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like, step: Optional[int] = None, shardings=None):
        """(tree, step) of the given or latest checkpoint, or (None,
        None) when there is none."""
        _refuse_shardings(shardings)
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return load_pytree(self.path(step), like), step

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step-(\d+)", n) for n in os.listdir(self.dir))
            if m)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.path(s), ignore_errors=True)
        # drop orphaned tmp dirs from crashed writers
        for n in os.listdir(self.dir):
            if n.startswith("tmp-"):
                shutil.rmtree(os.path.join(self.dir, n), ignore_errors=True)


def restore_train_state(mgr: CheckpointManager, state: Dict[str, Any], cfg,
                        step: Optional[int] = None):
    """(train state, step) restored from `mgr` into the structure of the
    port train state `state` (its "comp", if any, included), on its
    device; (None, None) without a checkpoint. Reads the JAX package's
    checkpoints and the port's alike."""
    meta = tu.tree_map(lambda t: t.to("meta"), state)
    tree, step = mgr.restore(CV.state_to_reference(meta, cfg), step)
    if tree is None:
        return None, None
    flat = {k: v.numpy() for k, v in tu.flatten_with_paths(tree).items()}
    return CV.state_from_flat(flat, cfg, state["step"].device), step


def save_train_state(mgr: CheckpointManager, step: int,
                     state: Dict[str, Any], cfg,
                     metadata: Optional[Dict] = None,
                     blocking: bool = True) -> None:
    """Save a port train state in the JAX package's layout: each leaf is
    copied to the host as it lies, and the layers are restacked there, on
    the writer's thread."""
    mgr.save(step, state, metadata, blocking,
             layout=lambda host: CV.state_to_reference(host, cfg))

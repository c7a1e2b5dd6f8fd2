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

  * Re-mesh: `load_pytree(..., shardings=)` and `restore(...,
    shardings=)` place every leaf on a device mesh: each rank slices its
    block out of the npz (`distributed.sharding.NamedSharding`) and the
    leaf comes back as a DTensor of the full shape, so a checkpoint
    written on one mesh restores onto another. `shardings` is one
    NamedSharding for every leaf, or a tree (or a dict keyed by leaf
    path) of them. Saving a tree of DTensors gathers each leaf
    (`full_tensor`, collective: every rank saves) and rank 0 writes,
    blocking, the others waiting at a barrier; the file is the same
    layout.
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


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _gathered(tree) -> bool:
    """Whether the tree holds DTensors: saving it gathers to rank 0."""
    return any(_is_dtensor(v) for v in tu.leaves(tree))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _host(x, copy: bool) -> np.ndarray:
    """A leaf as a host array; a copy of the leaf's memory with `copy`. A
    DTensor is gathered whole first (collective)."""
    if _is_dtensor(x):
        x, copy = x.full_tensor(), False
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=copy).numpy()
    return np.array(x, copy=copy) if copy else np.asarray(x)


def save_pytree(path: str, tree, metadata: Optional[Dict] = None) -> None:
    """Write `tree` as `arrays.npz` + `manifest.json` under `path`. A tree
    of DTensors is gathered (every rank calls) and written by rank 0."""
    arrays = {k: _host(v, copy=False)
              for k, v in tu.flatten_with_paths(tree).items()}
    if _gathered(tree):
        if _rank() == 0:
            _write(path, arrays, metadata)
        _barrier()
        return
    _write(path, arrays, metadata)


def _write(path: str, arrays: Dict[str, np.ndarray],
           metadata: Optional[Dict]) -> None:
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


def _sharding_for(shardings, key: str):
    from repro_torch.distributed.sharding import NamedSharding
    if isinstance(shardings, NamedSharding):
        return shardings
    flat = tu.flatten_with_paths(shardings)
    if key not in flat:
        raise KeyError(f"shardings has no entry for leaf {key}")
    return flat[key]


def load_pytree(path: str, like, shardings=None):
    """Restore into the structure of `like`: each leaf in like's type,
    dtype and device (a tensor on the 'meta' device, which lends only its
    shape and dtype, comes back on the CPU). With `shardings`, each leaf
    is this rank's block of it, read out of the file, as a DTensor of the
    full shape on the sharding's mesh."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    out = []
    for key, leaf in tu.items(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if shardings is None:
            out.append(_like(arr, leaf))
            continue
        sh = _sharding_for(shardings, key)
        local = _like(np.ascontiguousarray(sh.shard(arr)), leaf)
        out.append(sh.distribute(local, arr.shape))
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
        gathered = _gathered(tree)
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

        if gathered:
            # rank 0 writes the gathered tree; every rank leaves together
            if _rank() == 0:
                write()
            _barrier()
        elif blocking:
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
        None) when there is none; `shardings` as in `load_pytree`."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return load_pytree(self.path(step), like, shardings), step

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
                        step: Optional[int] = None, shardings=None):
    """(train state, step) restored from `mgr` into the structure of the
    port train state `state` (its "comp", if any, included), on its
    device; (None, None) without a checkpoint. Reads the JAX package's
    checkpoints and the port's alike. `shardings` (one NamedSharding, or
    a tree / path-keyed dict of them laid out like the port's state)
    places each leaf on a mesh: this rank's block, as a DTensor (the file
    stacks a scan slot's layers, so the blocks are cut after the
    unstacking)."""
    meta = tu.tree_map(lambda t: t.to("meta"), state)
    tree, step = mgr.restore(CV.state_to_reference(meta, cfg), step)
    if tree is None:
        return None, None
    flat = {k: v.numpy() for k, v in tu.flatten_with_paths(tree).items()}
    out = CV.state_from_flat(flat, cfg, state["step"].device)
    if shardings is not None:
        keys = list(tu.flatten_with_paths(out))
        out = tu.unflatten(out, [
            _sharding_for(shardings, k).distribute(
                _sharding_for(shardings, k).shard(v).contiguous(), v.shape)
            for k, v in zip(keys, tu.leaves(out))])
    return out, step


def save_train_state(mgr: CheckpointManager, step: int,
                     state: Dict[str, Any], cfg,
                     metadata: Optional[Dict] = None,
                     blocking: bool = True) -> None:
    """Save a port train state in the JAX package's layout: each leaf is
    copied to the host as it lies, and the layers are restacked there, on
    the writer's thread."""
    mgr.save(step, state, metadata, blocking,
             layout=lambda host: CV.state_to_reference(host, cfg))

"""Logical-axis sharding rules over a device mesh (port of
`repro.distributed.sharding`).

Mesh axes, JAX's names: ('data', 'model') on one pod, ('pod', 'data',
'model') across pods. A mesh is a `torch.distributed.device_mesh.DeviceMesh`
whose dimension names are those, or an `AbstractMesh` (axis sizes and
names, no devices: what the spec functions and the dry-run read).

A partition spec is a `PartitionSpec`: a tuple with one entry per tensor
dimension, each None (replicated), a mesh axis name, or a tuple of axis
names that together shard that dimension, major first. The spec functions
are pure and return the JAX package's specs entry for entry:
`param_pspecs` (name rules, FSDP x TP), `cache_pspecs` (slab and lock-step
caches), `page_pspecs` (a page-major store), `batch_pspec` (the slot or
batch axis). The port's trees are per layer where the JAX package stacks a
scan slot's layers, so a stacked leaf's leading None has no counterpart
here; an encoder-decoder's cross-attention leaves `cross_k` / `cross_v`
follow the rules of JAX's `cross/k` / `cross/v`.

`NamedSharding(mesh, spec)` places a full-shape leaf on the mesh: each
rank keeps the slice its mesh coordinate selects (`local_slices`), and
`placements` gives the same layout as DTensor placements (`Shard(d)` or
`Replicate()` per mesh dimension). `use_mesh` installs a mesh for the
model code: a decode whose cache leaf holds a rank's share of the kv heads
(or of the Mamba channels) computes those heads locally and all-gathers
their outputs over 'model' (`model_shard`, `all_gather_model`). A group
of one rank issues no collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tu


class PartitionSpec(tuple):
    """JAX's PartitionSpec as a plain tuple of entries; a one-axis tuple
    entry is that axis, as JAX normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


class AbstractMesh:
    """Axis sizes and names without devices (JAX's AbstractMesh): what the
    spec functions read when no process group exists."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError("one size per axis name")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a DeviceMesh or AbstractMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_axes(mesh))


def _shards(axes, mesh) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def _as_axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# Logical activation axes
# ---------------------------------------------------------------------------

def activation_rules(mesh, overrides: Optional[Dict] = None) -> Dict[str, Any]:
    """The JAX package's logical-axis rules for `mesh` (what its model's
    sharding constraints resolve to); the port's model code splits only
    decode attention and the Mamba recurrence, through `use_mesh`."""
    names = _axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in names) or None
    model = "model" if "model" in names else None
    rules = {
        "batch": batch,
        "seq": None,
        "seq_res": model,
        "heads": model,
        "kv_heads": model,
        "ffn": model,
        "vocab": model,
        "expert": model,
        "dm_in": None,
        "out_blocks": model,
    }
    if overrides:
        rules.update(overrides)
    return rules


_CURRENT: List[Any] = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` for the model code inside the block: a decode over a
    cache leaf that holds this rank's share of the heads reads the 'model'
    group from it (the port's model code has no other logical-axis
    constraint to resolve)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost `use_mesh` mesh, or None."""
    return _CURRENT[-1] if _CURRENT else None


def coordinate(mesh) -> Optional[Dict[str, int]]:
    """{axis: this rank's index} on the mesh, or None outside it."""
    get = getattr(mesh, "get_coordinate", None)
    coord = get() if get is not None else None
    if coord is None:
        return None
    return dict(zip(_axis_names(mesh), coord))


def in_mesh(mesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return coordinate(mesh) is not None


def axis_group(mesh, axis: str):
    """The process group of `axis` through this rank, or None for a
    one-rank axis (nothing to communicate)."""
    if mesh_axes(mesh)[axis] == 1:
        return None
    return mesh.get_group(axis)


def model_shard() -> Optional[Tuple[int, Any]]:
    """(this rank's index on 'model', the axis's group) under the current
    mesh, or None when no mesh with a 'model' axis is installed."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh_axes(mesh):
        return None
    coord = coordinate(mesh)
    if coord is None:
        return None
    return coord["model"], axis_group(mesh, "model")


def all_gather_axis(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's `x` of `group` along `dim`, in rank order
    (x itself for no group)."""
    if group is None:
        return x
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`all_gather_axis` over the current mesh's 'model' group."""
    shard = model_shard()
    return x if shard is None else all_gather_axis(x, dim, shard[1])


# ---------------------------------------------------------------------------
# Parameter partition specs (name-based)
# ---------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a", "wkv_b",
        "in_proj", "head"}
_ROW = {"wo", "w_down", "out_proj", "x_proj"}


def _spec_for(names: Tuple[str, ...], ndim: int, stacked: bool,
              fsdp_axis: Optional[str] = "data") -> PartitionSpec:
    base_ndim = ndim - (1 if stacked else 0)
    lead = (None,) if stacked else ()
    fa = fsdp_axis

    def mk(*axes):
        return P(*(lead + axes))

    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""

    if base_ndim == 3 and parent not in ("dt_proj",) and \
            leaf in ("w_gate", "w_up", "w_down"):
        if leaf == "w_down":
            return mk("model", None, fa)
        return mk("model", fa, None)
    if leaf == "emb":
        return mk("model", fa)
    if parent == "router" and leaf == "w":
        return mk(fa, "model")
    if parent == "dt_proj":
        return mk(None, "model") if base_ndim == 2 else mk("model")
    if leaf == "conv_w":
        return mk(None, "model")
    if leaf in ("conv_b", "D"):
        return mk("model")
    if leaf == "A_log":
        return mk("model", None)
    if leaf == "w" and parent in _COL:
        return mk(fa, "model")
    if leaf == "w" and parent in _ROW:
        return mk("model", fa)
    if leaf in ("scale", "bias"):
        return mk(*([None] * (base_ndim - 1) + ["model"]))
    if leaf == "w" and base_ndim == 2:
        return mk(fa, "model")
    return mk(*([None] * base_ndim))


def _sanitize_spec(spec, shape, mesh) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim
    (JAX refuses uneven shardings of jit arguments)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        out.append(entry if shape[i] % _shards(_as_axes(entry), mesh) == 0
                   else None)
    return P(*out)


def _path_names(path: str) -> Tuple[str, ...]:
    """'layers/#3/mixer/wq/w' -> ('layers', '[3]', 'mixer', 'wq', 'w')."""
    return tuple(f"[{p[1:]}]" if p.startswith("#") else p
                 for p in path.split("/"))


def param_pspecs(params, mesh=None) -> Dict[str, PartitionSpec]:
    """{leaf path: PartitionSpec} of a parameter tree (the port's per-layer
    tree: no leaf is stacked). A packed leaf (PackedLinear and the like)
    replicates, as its buffers fall through JAX's name rules."""
    out = {}
    for path, leaf in tu.flatten_with_paths(params).items():
        if not isinstance(leaf, torch.Tensor):
            out[path] = P()
            continue
        spec = _spec_for(_path_names(path), leaf.ndim, False)
        if mesh is not None:
            spec = _sanitize_spec(spec, tuple(leaf.shape), mesh)
        out[path] = spec
    return out


def param_shardings(mesh, params) -> Dict[str, "NamedSharding"]:
    return {k: NamedSharding(mesh, s)
            for k, s in param_pspecs(params, mesh).items()}


# ---------------------------------------------------------------------------
# Cache partition specs
# ---------------------------------------------------------------------------

# the port's cache leaves named otherwise than JAX's: a decoder layer's
# cross-attention k/v (JAX: cross/k, cross/v)
_CACHE_NAMES = {"cross_k": "k", "cross_v": "v"}


def cache_pspecs(caches, mesh, batch_size: int, *,
                 slab: bool = False) -> List[Dict[str, PartitionSpec]]:
    """Per-layer {leaf name: PartitionSpec} of a cache list
    (`transformer.make_caches`; meta tensors do): batch over
    ('pod', 'data') when divisible, else the cache sequence axis over
    'data'; 'model' on kv heads when divisible, else on the sequence; SSM
    d_inner over 'model'. slab=True: a serving slab whose leading axis is
    n_slots: a non-divisible slot count replicates, and an unknown leaf
    still shards its slot axis."""
    names = _axis_names(mesh)
    sizes = mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = _shards(dp_axes, mesh) if dp_axes else 1
    model_n = sizes["model"] if "model" in names else 1
    if dp_axes and batch_size % dp == 0:
        b_ax, seq_ax = dp_axes, None
    elif "data" in names and batch_size % sizes["data"] == 0:
        b_ax, seq_ax = "data", None
    elif slab:
        b_ax, seq_ax = None, None
    else:
        b_ax, seq_ax = None, "data"

    def raw(leafname, leaf):
        nd = len(leaf.shape)
        shape = tuple(leaf.shape)
        if leafname in ("k", "v"):          # (B, KV, S, dh)
            kv_n, s_n = shape[1], shape[2]
            if kv_n % model_n == 0:
                return P(b_ax, "model", seq_ax, None)
            if b_ax is not None:
                leaf_bytes = float(math.prod(shape)) * leaf.element_size()
                dpn = _shards(_as_axes(b_ax), mesh)
                if leaf_bytes / dpn <= (4 << 30):
                    return P(b_ax, None, seq_ax, None)
                m_batch = tuple(a for a in ("pod", "model") if a in names)
                mb_n = _shards(m_batch, mesh)
                if not slab and shape[0] % mb_n == 0 \
                        and s_n % sizes["data"] == 0:
                    return P(m_batch, None, "data", None)
                return P(b_ax, None, seq_ax, None)
            if slab:
                return P(b_ax, None, None, None)
            m_seq = "model" if seq_ax is None else (seq_ax, "model")
            if s_n % (model_n * (1 if seq_ax is None
                                 else sizes["data"])) == 0:
                return P(b_ax, None, m_seq, None)
            return P(b_ax, None, seq_ax, None)
        if leafname == "c_kv":              # (B, S, r)
            m_seq = None if slab else \
                ("model" if seq_ax is None else (seq_ax, "model"))
            return P(b_ax, m_seq, None)
        if leafname == "k_rope":            # (B, 1, S, dr)
            m_seq = None if slab else \
                ("model" if seq_ax is None else (seq_ax, "model"))
            return P(b_ax, None, m_seq, None)
        if leafname == "ssm":               # (B, di, st)
            return P(b_ax, "model", None)
        if leafname == "conv":              # (B, K-1, di)
            return P(b_ax, None, "model")
        if slab and nd >= 1 and shape and shape[0] == batch_size:
            return P(*((b_ax,) + (None,) * (nd - 1)))
        return P(*((None,) * nd))

    return [{name: _sanitize_spec(raw(_CACHE_NAMES.get(name, name), leaf),
                                  tuple(leaf.shape), mesh)
             for name, leaf in layer.items()} for layer in caches]


def page_pspecs(caches, layout, mesh, n_pages: int
                ) -> List[Dict[str, PartitionSpec]]:
    """Per-layer specs of a PAGE-MAJOR store (serve.paging): a paged leaf's
    page axis (where the slab's slot axis sat) shards like
    `batch_pspec(mesh, n_pages)`, the rest of its spec is the slab rule
    with the page-interior position axis cleared; resident leaves keep
    their slab spec. `caches` is the slab template of the layout."""
    slab_specs = cache_pspecs(caches, mesh, layout.n_slots, slab=True)
    page_entry = batch_pspec(mesh, n_pages)
    page_ent = page_entry[0] if len(page_entry) else None
    out = []
    for specs, shapes, store_shapes, paged in zip(
            slab_specs, layout.slab_shapes, layout.store_shapes(n_pages),
            layout.paged):
        layer = {}
        for name, spec in specs.items():
            if not paged[name]:
                layer[name] = spec
                continue
            ent = list(spec) + [None] * (len(shapes[name]) - len(spec))
            ent[0] = page_ent                # page axis replaces slot axis
            ent[-2] = None                   # page interior: never sharded
            layer[name] = _sanitize_spec(P(*ent), store_shapes[name], mesh)
        out.append(layer)
    return out


def batch_pspec(mesh, batch_size: int) -> PartitionSpec:
    """Batch-axis spec: the ('pod', 'data') tuple when the batch divides
    the dp axes (and the whole mesh, or there are several dp axes, or no
    'data'), a plain 'data' entry when it divides only the data axis,
    replicated otherwise."""
    names = _axis_names(mesh)
    sizes = mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp = _shards(dp_axes, mesh) if dp_axes else 1
    total = math.prod(sizes.values())
    if dp_axes and batch_size % dp == 0:
        if batch_size % total == 0 or len(dp_axes) > 1 \
                or "data" not in names:
            return P(dp_axes)
        return P("data")
    if "data" in names and batch_size % sizes["data"] == 0:
        return P("data")
    return P(None)


# ---------------------------------------------------------------------------
# Placement of a full-shape leaf on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> list:
    """The spec as DTensor placements, one per mesh dimension: Shard(d)
    where tensor dim d's entry names that axis, else Replicate(). An entry
    of several axes must list them in mesh order (major first), as DTensor
    shards a dimension over mesh dimensions in that order."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _as_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for p in pos:
            out[p] = Shard(d)
    return out


def local_slices(spec, shape, mesh, coord: Optional[Dict[str, int]] = None
                 ) -> Tuple[slice, ...]:
    """The slice of a full `shape` leaf that the rank at `coord` (default:
    this rank's mesh coordinate) keeps: on a dim sharded over axes
    (a, b, ...), block (i_a * n_b + i_b) ... of n_a * n_b ... equal
    blocks. A rank outside the mesh keeps nothing."""
    coord = coordinate(mesh) if coord is None else coord
    if coord is None:
        return tuple(slice(0, 0) for _ in shape)
    sizes = mesh_axes(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            out.append(slice(0, n))
            continue
        axes = _as_axes(entry)
        k = _shards(axes, mesh)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes}")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        step = n // k
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def shard_shape(spec, shape, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a full `shape` leaf."""
    return tuple(n // (1 if i >= len(spec) or spec[i] is None
                       else _shards(_as_axes(spec[i]), mesh))
                 for i, n in enumerate(shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A full-shape leaf's placement on `mesh` by `spec` (JAX's
    NamedSharding): each rank keeps `local_slices` of it."""

    mesh: Any
    spec: PartitionSpec

    def local_slices(self, shape) -> Tuple[slice, ...]:
        return local_slices(self.spec, shape, self.mesh)

    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def shard(self, full):
        """This rank's block of a full-shape tensor or array (a view)."""
        return full[self.local_slices(tuple(full.shape))]

    def distribute(self, local: torch.Tensor, shape):
        """A DTensor of the full `shape` from this rank's block."""
        from torch.distributed.tensor import DTensor
        stride = torch.empty(tuple(shape), device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements(),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

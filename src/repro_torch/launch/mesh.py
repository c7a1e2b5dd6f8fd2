"""Device meshes over the ranks of a process group, and the card's peaks
(port of `repro.launch.mesh`).

The port runs one process per device (the `torchrun` model): a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks of the default
process group, with the JAX package's axis names ('data', 'model'), or
('pod', 'data', 'model'). NCCL carries it on the card, gloo when the
caller asks for the CPU; nothing falls back from one to the other. A mesh
of one rank needs no group of its own: when no process group exists yet,
the builders start a one-rank group in process (a rank running alone).

Building a mesh of several ranks is collective: every rank of the group
builds the same meshes in the same order (`replica_meshes` builds every
replica's, and each rank serves those that hold it). A mesh whose size is
not the world's raises ValueError, as a JAX mesh over more devices than
exist does.

The constants are the data-sheet values of the card the port runs on, one
NVIDIA H100 80GB HBM3 (SXM form, dense, no structured-sparsity doubling):
the peaks every bound and roofline of the port is taken at
(`analysis.cost`, the figures, `chip_smoke.py`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# NVIDIA H100 80GB HBM3 (SXM) data sheet, per card
PEAK_BF16_FLOPS = 989e12        # FLOP/s, bf16 tensor cores
PEAK_INT8_OPS = 1979e12         # OP/s, int8 tensor cores
PEAK_F32_FLOPS = 67e12          # FLOP/s, f32 FMA on the CUDA cores
PEAK_TF32_FLOPS = 495e12        # FLOP/s, tf32 tensor cores
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80 * 10 ** 9        # 80 GB

# the peak of each operand type the port's kernels run in
PEAK_FLOPS = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16_FLOPS,
              "int8": PEAK_INT8_OPS}

AXES = ("data", "model")


def dist_backend(device) -> str:
    """The collective library for a device: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_world(device="cuda"):
    """The default process group, started as a one-rank group in process
    when none exists. Raises ValueError when the group's backend is not
    the device's (a gloo group never carries a CUDA mesh)."""
    import torch.distributed as dist
    want = dist_backend(device)
    if not dist.is_initialized():
        if want == "nccl" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                               "device='cpu' for a gloo mesh")
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have}; a "
                         f"{torch.device(device).type} mesh needs {want}")
    return dist.group.WORLD


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a local rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def join_torchrun(device="cuda") -> bool:
    """Join the process group torchrun describes (WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT in the environment) and return True; False
    when the process was not launched so."""
    import os

    from repro_torch.serve.backend import ensure_distributed
    if "WORLD_SIZE" not in os.environ:
        return False
    ensure_distributed(f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{os.environ['MASTER_PORT']}",
                       int(os.environ["WORLD_SIZE"]),
                       int(os.environ["RANK"]), device=device)
    return True


def _mesh(device, grid: np.ndarray, names):
    """A DeviceMesh over the ranks of `grid`; built collectively unless it
    holds one rank (which needs no group)."""
    from torch.distributed.device_mesh import DeviceMesh
    dt = torch.device(device).type
    return DeviceMesh(dt, torch.as_tensor(grid, dtype=torch.int64),
                      mesh_dim_names=tuple(names),
                      _init_backend=grid.size > 1)


def _world_size(device) -> int:
    import torch.distributed as dist
    ensure_world(device)
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    n = _world_size(device)
    if n != int(np.prod(shape)):
        raise ValueError(f"production mesh {shape} needs "
                         f"{int(np.prod(shape))} ranks, have {n}")
    return _mesh(device, np.arange(n).reshape(shape), axes)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A (data, model) mesh over every rank of the process group."""
    n = _world_size(device)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"ranks, have {n}")
    return _mesh(device, np.arange(n).reshape(data, model), AXES)


def parse_mesh_arg(spec: str) -> Tuple[int, int]:
    """'2,4' or 'data=2,model=4' -> (data, model): the serving launchers'
    `--mesh` grammar."""
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) != 2:
        raise ValueError(f"--mesh expects 'data,model', got {spec!r}")
    vals = {}
    for i, p in enumerate(parts):
        if "=" in p:
            k, v = p.split("=", 1)
            vals[k.strip()] = int(v)
        else:
            vals[AXES[i]] = int(p)
    if set(vals) != set(AXES) or min(vals.values()) < 1:
        raise ValueError(f"--mesh expects positive data,model sizes, "
                         f"got {spec!r}")
    return vals["data"], vals["model"]


def _check_split(data: int, n_replicas: int) -> None:
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if data % n_replicas:
        raise ValueError(f"data axis {data} does not divide into "
                         f"{n_replicas} replicas")


def replica_meshes(data: int, model: int, n_replicas: int, *,
                   device="cuda") -> List:
    """Split a (data, model) grid of the world's ranks into `n_replicas`
    disjoint submeshes along 'data', one serving replica each, every one
    keeping the whole 'model' axis. Collective: every rank builds all of
    them."""
    _check_split(data, n_replicas)
    need = data * model
    n = _world_size(device)
    if n != need:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, "
                         f"have {n}")
    grid = np.arange(need).reshape(n_replicas, data // n_replicas, model)
    return [_mesh(device, grid[i], AXES) for i in range(n_replicas)]


def _process_block(data: int, model: int, device) -> np.ndarray:
    """The ranks of the data x model block that holds this rank: the
    devices this process serves on, in a group of such blocks (one block
    is the whole group under torchrun; a fleet whose workers each own
    one device has a block per worker)."""
    import torch.distributed as dist
    need = data * model
    n = _world_size(device)
    rank = dist.get_rank()
    if n % need:
        raise ValueError(
            f"process mesh {data}x{model} needs {need} ranks per block, "
            f"process {rank} is in a group of {n}")
    return np.arange(n).reshape(n // need, need)


def process_meshes(data: int, model: int, n_replicas: int, *,
                   device="cuda") -> List:
    """`replica_meshes` over this process's block of ranks (see
    `_process_block`): in a group that is one block it is replica_meshes
    exactly, which keeps DistributedBackend token-identical to
    ShardedBackend. Blocks of several ranks are built collectively (every
    rank builds every block's meshes); one-rank blocks need no
    collective."""
    import torch.distributed as dist
    _check_split(data, n_replicas)
    blocks = _process_block(data, model, device)
    mine = dist.get_rank() // blocks.shape[1]
    shape = (n_replicas, data // n_replicas, model)
    if blocks.shape[1] == 1:
        return [_mesh(device, blocks[mine].reshape(shape)[0], AXES)]
    out = [[_mesh(device, g, AXES) for g in b.reshape(shape)]
           for b in blocks]
    return out[mine]


def _rank_names(ranks, device) -> List[str]:
    dt = torch.device(device).type
    return [f"{dt}:{int(r)}" for r in np.asarray(ranks).ravel()]


def fleet_topology(data: int, model: int, n_replicas: int, *,
                   device="cuda") -> dict:
    """Resolved process -> devices -> replica-mesh map for THIS process,
    JSON-safe (the JAX package's keys; a device is named by its rank)."""
    import torch.distributed as dist
    meshes = process_meshes(data, model, n_replicas, device=device)
    block = _process_block(data, model, device)[
        dist.get_rank() // (data * model)]
    return {
        "process_index": dist.get_rank(),
        "num_processes": dist.get_world_size(),
        "local_devices": _rank_names(block, device),
        "global_device_count": dist.get_world_size(),
        "mesh_shape": [data, model],
        "n_replicas": n_replicas,
        "replica_meshes": [
            {"replica": i,
             "shape": dict(zip(m.mesh_dim_names,
                               (int(s) for s in m.shape))),
             "devices": _rank_names(m.mesh, device)}
            for i, m in enumerate(meshes)],
    }


def plan_fleet_topology(n_processes: int, devices_per_process: int,
                        data: int, model: int, n_replicas: int) -> dict:
    """Arithmetic-only fleet plan: the constraints `process_meshes`
    enforces live, checked without a process group, so a launch can be
    validated before any worker or weight pack exists. Raises ValueError
    where process_meshes would."""
    if n_processes < 1:
        raise ValueError(f"n_processes must be >= 1, got {n_processes}")
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if data % n_replicas:
        raise ValueError(f"data axis {data} does not divide into "
                         f"{n_replicas} replicas")
    need = data * model
    if devices_per_process < need:
        raise ValueError(
            f"process mesh {data}x{model} needs {need} devices per "
            f"process, plan gives each of {n_processes} processes "
            f"{devices_per_process}")
    per = data // n_replicas
    procs = []
    for p in range(n_processes):
        devs = [f"cpu:{p}:{i}" for i in range(devices_per_process)]
        procs.append({
            "process_index": p,
            "local_devices": devs,
            "replica_meshes": [
                {"replica": r,
                 "shape": {"data": per, "model": model},
                 "devices": devs[r * per * model:(r + 1) * per * model]}
                for r in range(n_replicas)],
        })
    return {
        "num_processes": n_processes,
        "devices_per_process": devices_per_process,
        "global_device_count": n_processes * devices_per_process,
        "mesh_shape": [data, model],
        "n_replicas": n_replicas,
        "processes": procs,
    }

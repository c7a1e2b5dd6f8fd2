"""The card's peaks (port of the hardware constants of `repro.launch.mesh`).

The JAX package's module builds TPU meshes and keeps a TPU v5e's roofline
constants. The port runs on one NVIDIA H100 80GB HBM3: its constants are
that card's data-sheet values (SXM form, dense, no structured-sparsity
doubling), the peaks every bound and roofline of the port is taken at
(`analysis.cost`, the figures, `chip_smoke.py`). The mesh builders refuse
with NotImplementedError naming ROADMAP.md item 11, as the port's other
multi-device entry points do.
"""

from __future__ import annotations

MULTI_DEVICE = "ROADMAP.md queue 1, item 11 (multi-device)"

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


def _refuse(name: str):
    raise NotImplementedError(
        f"launch.mesh.{name}: device meshes are {MULTI_DEVICE} of the port, "
        "not ported yet")


def make_production_mesh(*, multi_pod: bool = False):
    _refuse("make_production_mesh")


def make_local_mesh(data: int = 1, model: int = 1):
    _refuse("make_local_mesh")


def parse_mesh_arg(spec: str):
    _refuse("parse_mesh_arg")


def replica_meshes(data: int, model: int, n_replicas: int):
    _refuse("replica_meshes")


def process_meshes(data: int, model: int, n_replicas: int):
    _refuse("process_meshes")


def fleet_topology(data: int, model: int, n_replicas: int):
    _refuse("fleet_topology")


def plan_fleet_topology(n_processes: int, devices_per_process: int,
                        data: int, model: int, n_replicas: int):
    _refuse("plan_fleet_topology")

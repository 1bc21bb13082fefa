"""Device meshes of the port and the card's hardware constants.

* ``make_sweep_mesh`` is the port's twin of the reference's function of
  the same name: a single ``"points"`` axis whose devices each simulate
  a contiguous slice of a point batch's lanes
  (``repro_torch.core.sweep.interference_lane_metrics_batch(mesh=...)``)
  — the run-farm analogue FireSim scales Fig. 5/6 with.
* ``make_production_mesh`` and ``make_host_mesh`` are the model
  meshes the sharding rules (``repro_torch.sharding``) resolve on:

  - single pod: (16, 16) over ("data", "model"), 256 GPUs;
  - multi-pod: (2, 16, 16) over ("pod", "data", "model"), 512 GPUs.

  ``model`` is tensor parallel (heads / mlp / vocab), ``data`` batch
  data parallel plus FSDP of the weights' d_model dims, ``pod`` a second
  data-parallel axis whose gradient reduction crosses the slowest links
  (where the int8 codec of ``train.compress`` applies).  A ``Mesh`` is
  names and sizes, which is all rule resolution reads, plus a
  ``torch.distributed`` ``DeviceMesh`` where a process group of the
  mesh's size exists.

Meshes are built by functions, never at import, so importing this
module touches no device and starts no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# Hardware constants of one NVIDIA H100 80GB HBM3 (SXM, 700.00 W power
# limit; NVIDIA's H100 data sheet, dense rates without sparsity — the
# bounds chip_smoke.py holds its kernels to).  Used by the dry-run's
# roofline, never at run time.
PEAK_BF16_FLOPS = 989e12          # bf16 tensor cores, per GPU
PEAK_INT8_OPS = 1979e12           # int8 tensor cores, per GPU
HBM_BW = 3.35e12                  # bytes/s per GPU
HBM_BYTES = 80 * 10**9            # per GPU
# NVLink 4: 18 links, 900 GB/s per GPU both directions together, so
# 450 GB/s each way — the collective term's link rate.  A mesh of 256
# GPUs spans 32 nodes of 8, whose links between nodes are slower, so
# the term is a lower bound there.
NVLINK_BW = 450e9                 # bytes/s per GPU, one direction


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device mesh: ``axis_names`` and ``shape`` (all that rule
    resolution reads), and the ``torch.distributed`` ``DeviceMesh``
    where a process group of the mesh's size exists (DTensor placements
    are then built on it)."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    device_mesh: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_mesh(shape, axis_names, *, device_type: str | None = None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``axis_names``, with a
    ``DeviceMesh`` of ``device_type`` (``cuda`` where available, else
    ``cpu``) when ``torch.distributed`` is initialised with a world of
    exactly the mesh's size."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    device_mesh = None
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh

        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        device_mesh = init_device_mesh(device_type, shape,
                                       mesh_dim_names=axis_names)
    return Mesh(axis_names, shape, device_mesh)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> Mesh:
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model") with ``multi_pod``; with a
    ``DeviceMesh`` when a process group of 256 (512) ranks exists."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         device_type=device_type)
    return make_mesh((16, 16), ("data", "model"), device_type=device_type)


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """Small ("data", "model") mesh over the visible CUDA devices:
    ``model_parallel`` of them (at most all) along ``model``, the rest
    along ``data``.  Raises when no CUDA device is visible."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device visible for the host mesh")
    n = torch.cuda.device_count()
    mp = max(1, min(model_parallel, n))
    return make_mesh((n // mp, mp), ("data", "model"), device_type="cuda")


@dataclasses.dataclass(frozen=True)
class SweepMesh:
    """A 1-D device mesh: ``devices`` along the ``"points"`` axis."""
    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("points",)


def make_sweep_mesh(devices=None) -> SweepMesh:
    """1-D campaign-sweep mesh over ``devices`` (anything
    ``torch.device`` accepts), in the order given.  ``devices=None``
    uses every visible CUDA device and raises when there is none; a
    single-device mesh is valid — it runs the whole batch on that
    device.  An explicit list may repeat a device (several CPU entries
    in the tests)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible for the sweep mesh — pass "
                "devices= explicitly (e.g. [torch.device('cpu')] * 3) to "
                "build one elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise RuntimeError("a sweep mesh needs at least one device")
    return SweepMesh(devices)

"""The campaign-sweep mesh: a 1-D list of torch devices.

``make_sweep_mesh`` is the port's twin of the reference's function of
the same name: a single ``"points"`` axis whose devices each simulate a
contiguous slice of a point batch's lanes
(``repro_torch.core.sweep.interference_lane_metrics_batch(mesh=...)``)
— the run-farm analogue FireSim scales Fig. 5/6 with.  Meshes are built
by a function, never at import, so importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses

import torch


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

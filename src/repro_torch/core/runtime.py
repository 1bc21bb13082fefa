"""Command-stream compiler: network descriptor -> accelerator/CPU ops.

NVDLA is driven by a command stream written over CSB: each hardware layer
is a descriptor naming operands (DRAM addresses), tiling, and the
post-processing chain; unsupported layers fall back to the host.  This
module is that compiler for our SoC model: it walks the YOLOv3 layer
table, assigns DBB addresses to every tensor, splits conv layers into
conv-buffer-sized tile passes, and emits:

* ``AccelOp`` — conv/shortcut descriptors with per-stream DBB traffic
  (weight / ifmap / ofmap bytes, burst-aligned) and MAC counts;
* ``CpuOp``   — upsample / route / yolo layers plus the fp32<->int8
  boundary conversions (counted element-wise, they run on the cores).

The tiling rule mirrors nv_large's operation: hold the smaller of
(weights, ifmap tile) resident in the 512 KiB conv buffer and stream the
other; when neither fits, the ifmap is tiled and the full weight set is
re-streamed once per tile — this is what makes some layers' weight
traffic a multiple of the weight bytes, and is exactly the spatial-
locality-heavy access pattern whose LLC behaviour the paper measures.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import yolov3
from repro_torch.core.yolov3 import Layer, accelerated


@dataclasses.dataclass(frozen=True)
class AccelOp:
    layer: Layer
    macs: int
    weight_traffic: int        # bytes read over DBB
    ifmap_traffic: int
    ofmap_traffic: int
    weight_passes: int         # how many times the weight set streams
    prev_ofmap_bytes: int      # producer's output (for LLC residency reuse)

    @property
    def read_traffic(self) -> int:
        return self.weight_traffic + self.ifmap_traffic

    @property
    def total_traffic(self) -> int:
        return self.read_traffic + self.ofmap_traffic


@dataclasses.dataclass(frozen=True)
class CpuOp:
    layer: Layer
    kind: str                  # upsample | route | yolo | cast
    elements: int              # elementwise work items
    bytes_moved: int


@dataclasses.dataclass(frozen=True)
class CommandStream:
    accel_ops: tuple
    cpu_ops: tuple

    @property
    def total_macs(self) -> int:
        return sum(op.macs for op in self.accel_ops)

    @property
    def accel_traffic(self) -> int:
        return sum(op.total_traffic for op in self.accel_ops)


def _tile_conv(l: Layer, conv_buf_bytes: int) -> tuple[int, int, int]:
    """Returns (weight_traffic, ifmap_traffic, weight_passes)."""
    wt, ifm = l.weight_bytes, l.ifmap_bytes
    half = conv_buf_bytes // 2
    if wt <= half or ifm <= half:
        # one operand resident -> both stream exactly once
        return wt, ifm, 1
    # neither fits: tile the ifmap into half-buffer chunks, re-stream the
    # full weight set per tile (NVDLA kernel-group iteration)
    n_tiles = -(-ifm // half)
    return wt * n_tiles, ifm, n_tiles


def compile_network(layers=None, *, conv_buf_bytes: int = 512 * 1024
                    ) -> CommandStream:
    layers = layers if layers is not None else yolov3.LAYERS
    accel_ops: list[AccelOp] = []
    cpu_ops: list[CpuOp] = []
    prev_of = 0
    on_accel_prev = False

    for l in layers:
        if accelerated(l):
            if l.kind == "conv":
                wt_t, if_t, passes = _tile_conv(l, conv_buf_bytes)
                macs = l.macs
            else:  # shortcut: SDP elementwise add, reads two maps
                wt_t, if_t, passes, macs = 0, 2 * l.ifmap_bytes, 1, 0
            if not on_accel_prev and l.index > 0:
                # fp32 -> int8 boundary conversion on the CPU
                cpu_ops.append(CpuOp(l, "cast", l.ifmap_bytes,
                                     5 * l.ifmap_bytes))
            accel_ops.append(AccelOp(
                layer=l, macs=macs, weight_traffic=wt_t, ifmap_traffic=if_t,
                ofmap_traffic=l.ofmap_bytes, weight_passes=passes,
                prev_ofmap_bytes=prev_of))
            on_accel_prev = True
        else:
            if on_accel_prev:
                # int8 -> fp32 conversion of the accelerator's output
                cpu_ops.append(CpuOp(l, "cast", l.ifmap_bytes,
                                     5 * l.ifmap_bytes))
            elems = l.out_h * l.out_w * l.cout
            cpu_ops.append(CpuOp(l, l.kind, elems,
                                 l.ifmap_bytes + 4 * elems))
            on_accel_prev = False
        prev_of = l.ofmap_bytes
    return CommandStream(tuple(accel_ops), tuple(cpu_ops))

"""YOLOv3-416 network descriptor (Redmon & Farhadi 2018; darknet cfg).

The paper's benchmark: 106 layers, 66 GOP per 416x416 frame.  This module
encodes the exact darknet layer table — Darknet-53 backbone (23 residual
blocks) + the 3-scale detection head with routes and upsamples — and the
per-layer compute/traffic accounting that feeds the accelerator model.

Layer kinds and their execution target (exactly the paper's Darknet/NVDLA
split):
* ``conv``      -> NVDLA conv core (int8)            [accelerator]
* ``shortcut``  -> NVDLA SDP elementwise add          [accelerator]
* ``upsample``  -> CPU (not supported by NVDLA)       [cpu]
* ``route``     -> CPU (concat / tensor copy)         [cpu]
* ``yolo``      -> CPU (custom detection layer)       [cpu]
plus the fp32<->int8 boundary conversions the paper calls out, attached to
the cpu ops that need them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Layer:
    index: int
    kind: str                  # conv | shortcut | route | upsample | yolo
    h: int                     # input spatial (square)
    w: int
    cin: int
    cout: int
    ksize: int = 0             # conv only
    stride: int = 1
    out_h: int = 0
    out_w: int = 0
    frm: tuple = ()            # route/shortcut source layer indices

    @property
    def macs(self) -> int:
        if self.kind != "conv":
            return 0
        return self.out_h * self.out_w * self.ksize * self.ksize \
            * self.cin * self.cout

    @property
    def weight_bytes(self) -> int:  # int8 weights
        if self.kind != "conv":
            return 0
        return self.ksize * self.ksize * self.cin * self.cout

    @property
    def ifmap_bytes(self) -> int:   # int8 activations
        return self.h * self.w * self.cin

    @property
    def ofmap_bytes(self) -> int:
        return self.out_h * self.out_w * self.cout


def _build() -> list[Layer]:
    layers: list[Layer] = []
    h = w = 416
    c = 3
    outs: list[tuple[int, int, int]] = []   # (h, w, c) per layer

    def add_conv(cout, k, stride):
        nonlocal h, w, c
        i = len(layers)
        oh, ow = h // stride, w // stride
        layers.append(Layer(i, "conv", h, w, c, cout, k, stride, oh, ow))
        h, w, c = oh, ow, cout
        outs.append((h, w, c))

    def add_shortcut(frm):
        nonlocal h, w, c
        i = len(layers)
        layers.append(Layer(i, "shortcut", h, w, c, c, 0, 1, h, w,
                            (i + frm,)))
        outs.append((h, w, c))

    def add_route(srcs):
        nonlocal h, w, c
        i = len(layers)
        abs_srcs = tuple(s if s >= 0 else i + s for s in srcs)
        hh, ww, _ = outs[abs_srcs[0]]
        cc = sum(outs[s][2] for s in abs_srcs)
        layers.append(Layer(i, "route", hh, ww, cc, cc, 0, 1, hh, ww,
                            abs_srcs))
        h, w, c = hh, ww, cc
        outs.append((h, w, c))

    def add_upsample():
        nonlocal h, w, c
        i = len(layers)
        layers.append(Layer(i, "upsample", h, w, c, c, 0, 1, h * 2, w * 2))
        h, w = h * 2, w * 2
        outs.append((h, w, c))

    def add_yolo():
        i = len(layers)
        layers.append(Layer(i, "yolo", h, w, c, c, 0, 1, h, w))
        outs.append((h, w, c))

    def res_block(c_half):
        add_conv(c_half, 1, 1)
        add_conv(c_half * 2, 3, 1)
        add_shortcut(-3)

    # ---- Darknet-53 backbone ------------------------------------------
    add_conv(32, 3, 1)            # 0
    add_conv(64, 3, 2)            # 1 downsample
    res_block(32)                 # 2-4
    add_conv(128, 3, 2)           # 5
    for _ in range(2):
        res_block(64)             # 6-11
    add_conv(256, 3, 2)           # 12
    for _ in range(8):
        res_block(128)            # 13-36 (layer 36 out: 52x52x256)
    add_conv(512, 3, 2)           # 37
    for _ in range(8):
        res_block(256)            # 38-61 (layer 61 out: 26x26x512)
    add_conv(1024, 3, 2)          # 62
    for _ in range(4):
        res_block(512)            # 63-74

    # ---- head, scale 1 (13x13) ----------------------------------------
    for _ in range(2):
        add_conv(512, 1, 1)
        add_conv(1024, 3, 1)
    add_conv(512, 1, 1)           # 79
    add_conv(1024, 3, 1)          # 80
    add_conv(255, 1, 1)           # 81
    add_yolo()                    # 82
    # ---- scale 2 (26x26) ----------------------------------------------
    add_route((-4,))              # 83 (from 79)
    add_conv(256, 1, 1)           # 84
    add_upsample()                # 85
    add_route((-1, 61))           # 86
    for _ in range(2):
        add_conv(256, 1, 1)
        add_conv(512, 3, 1)
    add_conv(256, 1, 1)           # 91
    add_conv(512, 3, 1)           # 92
    add_conv(255, 1, 1)           # 93
    add_yolo()                    # 94
    # ---- scale 3 (52x52) ----------------------------------------------
    add_route((-4,))              # 95 (from 91)
    add_conv(128, 1, 1)           # 96
    add_upsample()                # 97
    add_route((-1, 36))           # 98
    for _ in range(3):
        add_conv(128, 1, 1)
        add_conv(256, 3, 1)
    add_conv(255, 1, 1)           # 105
    add_yolo()                    # 106

    return layers


LAYERS: list[Layer] = _build()


def total_macs() -> int:
    return sum(l.macs for l in LAYERS)


def total_gops() -> float:
    """2 ops per MAC, the convention behind the paper's '66 billion ops'."""
    return 2.0 * total_macs() / 1e9


def total_weight_bytes() -> int:
    return sum(l.weight_bytes for l in LAYERS)


def accelerated(l: Layer) -> bool:
    """NVDLA executes convs and elementwise shortcuts; the rest is CPU —
    the paper's split (upsample, routes, yolo layers + fp/int casts)."""
    return l.kind in ("conv", "shortcut")

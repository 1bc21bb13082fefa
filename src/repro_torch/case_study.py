"""YOLOv3 on the NVDLA/RISC-V SoC model — the paper's full case study,
run on the GPU.

Three parts, as in ``examples/yolov3_soc_sim.py`` of the reference:
1. the command stream (the accel/CPU split of all 107 layers),
2. a *numeric* int8 inference of darknet's first two conv layers and a
   2x2 max-pool through the convcore + postproc Hopper kernels, each
   conv held against its plain version,
3. the three performance experiments (Figs 4/5/6), plus the simulated
   mode, whose exact LLC replay runs on the device.

Run:  PYTHONPATH=src python -m repro_torch [--device cuda] [--size 64]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    interference_sweep,
    llc_sweep,
    platform_table,
    run_yolov3,
)
from repro_torch.core.quant import calibrate, quantize, quantize_conv_weights
from repro_torch.core.runtime import compile_network
from repro_torch.core.yolov3 import LAYERS, total_gops
from repro_torch.kernels.convcore import conv2d_int8
from repro_torch.kernels.convcore.ref import conv2d_int8_ref
from repro_torch.kernels.postproc import postprocess
from repro_torch.utils.env import default_device

STAGE_CONVS = ((32, 3, 1), (64, 3, 2))   # darknet layers 0-1: (cout, k, stride)
FIG5_SIZES_KIB = (0.5, 64, 1024, 4096)
FIG5_BLOCKS = (32, 64, 128)


def show_command_stream():
    stream = compile_network()
    print(f"YOLOv3-416: {len(LAYERS)} layers, {total_gops():.1f} GOP/frame")
    print(f"  accelerator ops: {len(stream.accel_ops)} "
          f"(convs+shortcuts), traffic {stream.accel_traffic/1e6:.0f} MB")
    print(f"  cpu ops:         {len(stream.cpu_ops)} "
          f"(upsample/route/yolo/casts)")
    heavy = max(stream.accel_ops, key=lambda op: op.macs)
    print(f"  heaviest conv: layer {heavy.layer.index} "
          f"{heavy.layer.h}x{heavy.layer.w}x{heavy.layer.cin}"
          f"->{heavy.layer.cout}, {heavy.macs/1e9:.2f} GMAC, "
          f"{heavy.weight_passes} weight pass(es)")
    return stream


def stage_layers(*, seed: int, device) -> list[dict]:
    """The stage's conv layers: seeded fp32 weights (normal * 0.1, drawn
    on the CPU so every device gets the same ones), int8-quantized per
    output channel, zero bias."""
    gen = torch.Generator().manual_seed(seed)
    layers, cin = [], 3
    for cout, k, stride in STAGE_CONVS:
        w = torch.randn((k, k, cin, cout), generator=gen) * 0.1
        wq, sw = quantize_conv_weights(w)
        layers.append({"w": wq.to(device), "w_scale": sw.to(device),
                       "bias": torch.zeros(cout, device=device),
                       "stride": stride, "padding": 1})
        cin = cout
    return layers


def int8_stage(x: torch.Tensor, layers: list[dict]) -> dict:
    """x (N, H, W, 3) fp32 through the int8 stage: calibrate + quantize,
    each conv (fused ReLU, fp32 out) on the conv core and on its plain
    version, requantize, then a 2x2 max-pool on the post-processor.
    Returns each conv's (int8 input, output, plain output) and the
    pooled map."""
    sx = calibrate(x)
    acc = quantize(x, sx)
    convs = []
    for p in layers:
        args = (acc, p["w"], sx * p["w_scale"], p["bias"])
        kw = dict(stride=p["stride"], padding=p["padding"], relu=True,
                  out_dtype=torch.float32)
        out = conv2d_int8(*args, **kw)
        convs.append((acc, out, conv2d_int8_ref(*args, **kw)))
        sx = calibrate(out)
        acc = quantize(out, sx)
    c = out.shape[-1]
    pooled = postprocess(out, torch.ones(c, device=out.device),
                         torch.zeros(c, device=out.device), act="none",
                         pool=2)
    return {"convs": convs, "pooled": pooled}


def numeric_int8_stage(*, size: int, seed: int, device) -> dict:
    """Run darknet's first two conv layers numerically in int8 on the
    convcore kernel, on a seeded size x size input (416 is the model's
    own; 64 keeps a CPU run short)."""
    print("\nnumeric int8 stage (convcore + postproc kernels):")
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, size, size, 3), generator=gen).to(device)
    res = int8_stage(x, stage_layers(seed=seed + 1, device=device))
    for i, (inp, out, ref) in enumerate(res["convs"]):
        err = float((out - ref).abs().max())
        print(f"  conv{i}: {tuple(inp.shape)} -> {tuple(out.shape)}, "
              f"kernel==ref err {err:.2e}")
    print(f"  postproc 2x2 maxpool: {tuple(out.shape)} -> "
          f"{tuple(res['pooled'].shape)}")
    return res


def performance_experiments(*, device) -> dict:
    print("\nperformance experiments:")
    t = platform_table()
    for k, v in t.items():
        if k != "_meta":
            print(f"  {k:28s} {v:8.3f} fps")
    m = t["_meta"]
    print(f"  NVDLA split: {m['nvdla_accel_ms']:.1f} ms accel + "
          f"{m['nvdla_cpu_ms']:.1f} ms cpu (paper: 67 + 66)")

    sw = llc_sweep(sizes_kib=FIG5_SIZES_KIB, blocks=FIG5_BLOCKS)
    print("  LLC speedup grid (vs no LLC):")
    for (size, block), sp in sorted(sw["grid"].items()):
        print(f"    {size:7.1f} KiB / {block:3d} B : {sp:.3f}x")

    isw = interference_sweep()
    print("  interference (normalized NVDLA time):")
    for wss in ("l1", "llc", "dram"):
        row = "  ".join(f"{isw[wss][n]:.2f}" for n in (0, 1, 2, 3, 4))
        print(f"    WSS={wss:4s}: {row}")

    sim = run_yolov3(mode="simulated", device=device)
    print(f"  simulated mode (exact LLC replay on {device}): "
          f"{sim.accel_s * 1e3:.3f} ms accel")
    ssw = llc_sweep(sizes_kib=FIG5_SIZES_KIB, blocks=FIG5_BLOCKS,
                    mode="simulated", device=device)
    print("  simulated LLC speedup grid (vs no LLC):")
    for (size, block), sp in sorted(ssw["grid"].items()):
        print(f"    {size:7.1f} KiB / {block:3d} B : {sp:.3f}x")
    return {"platform": t, "llc": sw, "interference": isw,
            "simulated": sim, "simulated_llc": ssw}


def run(*, device=None, size: int = 64, seed: int = 0) -> dict:
    """The whole case study on ``device`` (``cuda`` when None)."""
    dev = default_device(device)
    stream = show_command_stream()
    stage = numeric_int8_stage(size=size, seed=seed, device=dev)
    perf = performance_experiments(device=dev)
    return {"stream": stream, "stage": stage, **perf}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--size", type=int, default=64,
                    help="numeric stage input size (416: the model's own)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(device=args.device, size=args.size, seed=args.seed)
    return 0

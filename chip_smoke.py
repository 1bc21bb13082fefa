#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

Builds the port's Hopper kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the
port's two paths through them:

* the YOLOv3 case study (``repro_torch.case_study``) at the model's full
  416 x 416 width plus all 75 conv layers of a frame, and the paper
  chain (model-mode anchors exactly, simulated mode on the card bit for
  bit against the CPU);
* serving mamba2-130m at full width (``repro_torch.serve.ServeEngine``,
  24 layers, d_model 768, random weights from a seed): 8 requests of
  512 and 300 tokens, 32 new tokens each, 4 slots, with the engine's
  stats, step log and oracle costs held exactly to the JAX reference's
  (anchors below, from the reference on the CPU) and each prefill
  group's first-token logits held to the same prefill through the SSD
  step's plain version.

Then it times every kernel beside its plain version, a PyTorch library
call where one computes the same function, and its roofline bound.

Run from the repository root:   python3 chip_smoke.py

Prints each phase, then the card's name and power limit (as nvidia-smi
gives them), a JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  Per-layer timings also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): int8 tensor cores and HBM3
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)

# test_kernels.py's shapes, then YOLOv3-416 layer 0 and layer 1 (the
# heaviest conv, 0.80 GMAC)
MATMUL_SHAPES = [(128, 128, 128), (256, 512, 256), (384, 640, 128),
                 (100, 200, 60), (1, 2048, 1000), (173056, 27, 32),
                 (43264, 288, 64)]
POSTPROC_SHAPES = [(2, 32, 32, 16), (2, 64, 64, 8), (2, 30, 30, 8),
                   (2, 16, 16, 128), (1, 208, 208, 64)]
ACTS = ("none", "relu", "sigmoid", "tanh")
DTYPES = (torch.float32, torch.bfloat16)
FIG5 = dict(sizes_kib=(0.5, 64, 1024, 4096), blocks=(32, 64, 128))

# SSD intra-chunk (bb, l, chunk, h, p, n): test_kernels.py's shapes, the
# serving path's full width (4 prompts of 512 = 2 chunks of 256) and a
# 300-token prompt (one ragged chunk of 300)
SSD_SHAPES = [(2, 64, 32, 4, 16, 32), (2, 128, 32, 8, 32, 64),
              (2, 32, 32, 2, 16, 16), (4, 512, 256, 24, 64, 128),
              (4, 300, 256, 24, 64, 128)]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)   # the reference's own for this kernel
# first-token logits, SSD step through the kernel vs its plain version,
# bf16 model: the reference's one-step bf16 decode-parity tolerance
LOGITS_TOL = dict(rtol=2e-2, atol=0.08)

# Full-width mamba2-130m serving anchors: the JAX reference's
# ServeEngine on the same traffic (CPU), EngineStats.to_record() and the
# step log as runs of (kind, cycles, steps); oracle costs for 4 requests
# of (512, 32) in PagedKVCache(num_blocks=140, block_size=16,
# token_bytes=1).
SERVE_STATS = {
    "requests": 8, "tokens": 256, "steps": 65, "prefill_steps": 4,
    "decode_steps": 64, "idle_steps": 0, "sim_time_s": 5.9693022175,
    "tokens_per_s": 42.88608461630465, "latency_p50_s": 3.05363894,
    "latency_p99_s": 5.9688022175, "mean_occupancy": 3.9384615384615387,
    "max_occupancy": 4}
SERVE_STEP_RUNS = [("prefill", 221081060, 1), ("mixed", 458566932, 1),
                   ("decode", 286698068, 30), ("mixed", 491374576, 1),
                   ("mixed", 458566932, 1), ("decode", 286698068, 30),
                   ("decode", 270293516, 1)]
ORACLE_PREFILL_CYCLES = 221_082_288     # prefill_step(kv, [0, 1])
ORACLE_DECODE_CYCLES = 286_698_068      # decode_step(kv, [0, 1, 2, 3])
ORACLE_DECODE_HIT_RATE = 0.5


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_close(got, want, what: str) -> float:
    """fp32: rtol = atol = 1e-5; bf16: at most one bf16 ulp."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        if not bool(((g - w).abs() <= ulp).all()):
            raise AssertionError(f"{what}: bf16 outputs differ by more "
                                 "than one ulp")
    else:
        torch.testing.assert_close(got, want, msg=what, **TOL)
    return max_err(got, want)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls,
    bracketed by CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_int8(shape, gen, dev):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def setup() -> str:
    phase("setup")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return smi


def check_kernels(dev) -> dict:
    """Every kernel against its plain version on the card, at
    test_kernels.py's shapes and the main path's, both output dtypes,
    every activation and pool."""
    from repro_torch.kernels.convcore import matmul_int8
    from repro_torch.kernels.convcore.ref import matmul_int8_ref
    from repro_torch.kernels.postproc import postprocess
    from repro_torch.kernels.postproc.ref import postprocess_ref

    phase("kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"convcore": 0.0, "postproc": 0.0}
    for m, k, n in MATMUL_SHAPES:
        a, b = rand_int8((m, k), gen, dev), rand_int8((k, n), gen, dev)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-2 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev)
        worst = 0.0
        for out_dtype in DTYPES:
            for relu in (False, True):
                got = matmul_int8(a, b, scale, bias, relu=relu,
                                  out_dtype=out_dtype)
                want = matmul_int8_ref(a, b, scale, bias, relu=relu,
                                       out_dtype=out_dtype)
                err = check_close(got, want, f"matmul {m}x{k}x{n}")
                if out_dtype == torch.float32:
                    worst = max(worst, err)
        ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        exact = matmul_int8(a, b, ones, zeros, out_dtype=torch.float32)
        if not torch.equal(exact, (a.double() @ b.double()).float()):
            raise AssertionError(f"matmul {m}x{k}x{n}: int accumulation "
                                 "not exact")
        errs["convcore"] = max(errs["convcore"], worst)
        print(f"  convcore {m}x{k}x{n}: fp32 max err {worst:.2e}, bf16 "
              "within 1 ulp, int accumulation exact")
    for shape in POSTPROC_SHAPES:
        c = shape[-1]
        worst = 0.0
        for in_dtype in DTYPES:
            x = torch.randn(shape, generator=gen, device=dev).to(in_dtype)
            scale = torch.rand(c, generator=gen, device=dev) * 4 - 2
            bias = torch.randn(c, generator=gen, device=dev)
            for act in ACTS:
                for pool in (1, 2):
                    for out_dtype in DTYPES:
                        kw = dict(act=act, pool=pool, out_dtype=out_dtype)
                        got = postprocess(x, scale, bias, **kw)
                        want = postprocess_ref(x, scale, bias, **kw)
                        err = check_close(got, want,
                                          f"postproc {shape} {kw}")
                        if out_dtype == torch.float32:
                            worst = max(worst, err)
        errs["postproc"] = max(errs["postproc"], worst)
        print(f"  postproc {shape}: fp32 max err {worst:.2e}, bf16 within "
              "1 ulp (4 acts x 2 pools x 2 in x 2 out dtypes)")
    torch.cuda.synchronize()
    return errs


def ssd_inputs(bb, l, h, p, n, gen, dev):
    """Seeded SSD operands: x, post-softplus dt, negative A, B, C."""
    x = torch.randn((bb, l, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bb, l, h), generator=gen, device=dev))
    A = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
    B = torch.randn((bb, l, n), generator=gen, device=dev)
    C = torch.randn((bb, l, n), generator=gen, device=dev)
    return x, dt, A, B, C


def check_ssd(dev) -> float:
    """The SSD kernel against its plain version on the card: y_intra and
    states within rtol = atol = 1e-4."""
    from repro_torch.kernels.ssd import ops

    phase("ssd against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for bb, l, chunk, h, p, n in SSD_SHAPES:
        args = ssd_inputs(bb, l, h, p, n, gen, dev)
        y, states, cum = ops.ssd_intra_chunk(*args, chunk=chunk)
        want_y, want_states, want_cum = ops.ssd_intra_chunk_plain(
            *args, chunk=chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
        torch.testing.assert_close(y, want_y, **SSD_TOL)
        torch.testing.assert_close(states, want_states, **SSD_TOL)
        ey, es = max_err(y, want_y), max_err(states, want_states)
        worst = max(worst, ey, es)
        print(f"  ssd bb {bb} l {l} q {cum.shape[2]} h {h} p {p} n {n}: "
              f"max abs err y {ey:.2e}, states {es:.2e} (|y| up to "
              f"{float(want_y.abs().max()):.1f})")
    return worst


def frame_layers():
    from repro_torch.core.yolov3 import LAYERS

    return [l for l in LAYERS if l.kind == "conv"]


def frame_inputs(l, gen, dev):
    """Seeded int8 input and weights of one conv layer at its own
    shape, with a per-channel scale and bias."""
    x = rand_int8((1, l.h, l.w, l.cin), gen, dev)
    w = rand_int8((l.ksize, l.ksize, l.cin, l.cout), gen, dev)
    scale = torch.rand(l.cout, generator=gen, device=dev) * 1e-3 + 1e-5
    bias = torch.randn(l.cout, generator=gen, device=dev)
    return x, w, scale, bias


def main_path(dev) -> tuple[dict, dict, dict]:
    """The port's main path, with every launch counter at 0 before it:
    the case study at 416 x 416, then a frame's 75 convs, each held
    against the plain direct convolution."""
    from repro_torch import case_study
    from repro_torch.kernels.convcore import conv2d_int8
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.convcore.ref import conv2d_int8_ref
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.postproc.ref import postprocess_ref

    phase("main path: python -m repro_torch --size 416, then a frame's "
          "75 convs")
    cc_kernel.launches = 0
    pp_kernel.launches = 0
    t0 = time.perf_counter()
    res = case_study.run(device=dev, size=416, seed=0)
    torch.cuda.synchronize()
    print(f"case study wall time {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"convcore": 0.0, "postproc": 0.0}
    layers = frame_layers()
    for l in layers:
        x, w, scale, bias = frame_inputs(l, gen, dev)
        kw = dict(stride=l.stride, padding=l.ksize // 2, relu=True,
                  out_dtype=torch.float32)
        out = conv2d_int8(x, w, scale, bias, **kw)
        if tuple(out.shape) != (1, l.out_h, l.out_w, l.cout):
            raise AssertionError(f"layer {l.index}: shape {out.shape}")
        err = check_close(out, conv2d_int8_ref(x, w, scale, bias, **kw),
                          f"layer {l.index}")
        errs["convcore"] = max(errs["convcore"], err)
    torch.cuda.synchronize()
    launches = {"convcore": cc_kernel.launches,
                "postproc": pp_kernel.launches}
    print(f"{len(layers)} conv layers held against the plain conv: fp32 "
          f"max err {errs['convcore']:.2e}")
    print(f"launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")

    stage = res["stage"]
    shapes = [tuple(out.shape) for _, out, _ in stage["convs"]]
    if shapes != [(1, 416, 416, 32), (1, 208, 208, 64)] or \
            tuple(stage["pooled"].shape) != (1, 104, 104, 64):
        raise AssertionError(f"numeric stage shapes {shapes}, "
                             f"{tuple(stage['pooled'].shape)}")
    for _, out, ref in stage["convs"]:
        err = check_close(out, ref, "numeric stage conv")
        errs["convcore"] = max(errs["convcore"], err)
    c = out.shape[-1]
    pooled_ref = postprocess_ref(out, torch.ones(c, device=dev),
                                 torch.zeros(c, device=dev), act="none",
                                 pool=2)
    check_close(stage["pooled"], pooled_ref, "numeric stage max-pool")
    errs["postproc"] = max_err(stage["pooled"], pooled_ref)
    if not bool(torch.isfinite(stage["pooled"]).all()):
        raise AssertionError("pooled map is not finite")
    return res, launches, errs


def paper_chain(res: dict, dev) -> dict:
    """Model-mode anchors exactly; simulated mode on the card bit for
    bit against the port's CPU run."""
    from repro_torch.core.soc import llc_sweep, run_yolov3

    phase("paper chain")
    t = res["platform"]
    m = t["_meta"]
    got = (round(m["nvdla_accel_ms"], 3), round(m["nvdla_cpu_ms"], 3),
           round(t["nvdla (int8)"], 3), round(m["speedup_vs_rocket"], 2),
           round(res["llc"]["grid"][(4096, 128)], 4),
           tuple(round(res["llc"]["grid"][(1024, b)], 4)
                 for b in (32, 64, 128)),
           round(res["interference"]["llc"][4], 4),
           round(res["interference"]["dram"][4], 4))
    want = (69.134, 66.115, 7.394, 406.47, 1.5570,
            (1.0611, 1.3414, 1.5455), 2.0728, 2.4457)
    if got != want:
        raise AssertionError(f"model-mode anchors {got} != {want}")
    print(f"model-mode anchors equal: {want}")

    times = {}
    t0 = time.perf_counter()
    sim_gpu = run_yolov3(mode="simulated", device=dev)
    times["frame_cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_gpu = llc_sweep(mode="simulated", device=dev, **FIG5)
    times["fig5_cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_cpu = run_yolov3(mode="simulated", device="cpu")
    times["frame_cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_cpu = llc_sweep(mode="simulated", device="cpu", **FIG5)
    times["fig5_cpu_s"] = time.perf_counter() - t0
    if sim_gpu.accel_s != sim_cpu.accel_s or \
            res["simulated"].accel_s != sim_cpu.accel_s or \
            sim_cpu.accel_s * 1e3 != 65.13808718588858:
        raise AssertionError(f"simulated frame: cuda {sim_gpu.accel_s!r}, "
                             f"cpu {sim_cpu.accel_s!r}")
    if sweep_gpu != sweep_cpu or res["simulated_llc"] != sweep_cpu:
        raise AssertionError("simulated Fig. 5 grid differs between cuda "
                             "and cpu")
    print(f"simulated frame {sim_gpu.accel_s * 1e3!r} ms accel and the "
          "12-point simulated Fig. 5 grid: cuda == cpu, bit for bit")
    print("segment-lane engine wall time: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    return times


def serve_requests(vocab: int) -> list:
    """The 8 requests of the serving path: prompt lengths alternating
    512 and 300, tokens drawn as examples/serve_lm.py draws them, 32 new
    tokens each, arrivals 100 µs apart."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    return [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
                3, vocab, 512 if i % 2 == 0 else 300)),
                    max_new=32, arrival_s=i * 100e-6) for i in range(8)]


def serve_path(dev) -> tuple[dict, dict]:
    """The serving main path, with every launch counter at 0 before it:
    mamba2-130m at full width through ServeEngine, held to the JAX
    reference's anchors; then each prefill group's first-token logits
    through the kernel against the plain SSD step, and the kernel
    against its plain version on every layer's SSD operands of those
    prefills."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import (
        decode_working_set,
        init_caches,
        init_params,
        prefill,
        slot_decode_step,
    )
    from repro_torch.serve import PagedKVCache, ServeEngine, SoCLatencyOracle
    from repro_torch.types import param_values

    phase("serving path: mamba2-130m at full width through ServeEngine")
    cfg = get_config("mamba2-130m")
    params = param_values(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    eng = ServeEngine(cfg, params, cache_len=552, max_slots=4,
                      temperature=0.0, eos_id=-1, device=dev)
    requests = serve_requests(cfg.vocab_size)
    for req in requests:
        eng.submit(req)
    cc_kernel.launches = pp_kernel.launches = ssd_kernel.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"convcore": cc_kernel.launches,
                "postproc": pp_kernel.launches, "ssd": ssd_kernel.launches}
    record = stats.to_record()
    print(f"EngineStats {json.dumps(record)}")
    print(f"serve wall time {wall:.2f} s: model (prefill + decode) "
          f"{eng.wall_s['model']:.2f} s, oracle {eng.wall_s['oracle']:.2f}"
          f" s, {len(eng.oracle._memo)} distinct oracle traces")

    # the prefill groups the engine ran: per admitting step, by length
    by_rid = {r.rid: r for r in requests}
    groups = []
    for step in eng.step_log:
        lens = sorted({len(by_rid[r].tokens) for r in step.admitted})
        groups += [[r for r in step.admitted
                    if len(by_rid[r].tokens) == n] for n in lens]
    print(f"ssd launches on the serving path: {launches['ssd']} "
          f"({len(groups)} prefill groups x {cfg.num_layers} layers)")
    if launches["ssd"] != cfg.num_layers * len(groups):
        raise AssertionError(f"ssd launched {launches['ssd']} times, not "
                             f"{cfg.num_layers} per prefill group")
    if record != SERVE_STATS:
        raise AssertionError(f"EngineStats differ from the reference's: "
                             f"{record} != {SERVE_STATS}")
    runs = []
    for r in eng.step_log:
        if runs and runs[-1][:2] == (r.kind, r.cycles):
            runs[-1] = (r.kind, r.cycles, runs[-1][2] + 1)
        else:
            runs.append((r.kind, r.cycles, 1))
    if runs != SERVE_STEP_RUNS:
        raise AssertionError(f"step kinds/cycles {runs} != the "
                             f"reference's {SERVE_STEP_RUNS}")
    print(f"EngineStats and the {len(eng.step_log)} steps' kinds and "
          "cycles equal the JAX reference's, bit for bit")

    oracle = SoCLatencyOracle(decode_working_set(cfg), device=dev)
    kv = PagedKVCache(num_blocks=140, block_size=16, token_bytes=1)
    for rid in range(4):
        kv.admit(rid, 512, 32)
    t0 = time.perf_counter()
    pre = oracle.prefill_step(kv, [0, 1])
    t1 = time.perf_counter()
    dec = oracle.decode_step(kv, [0, 1, 2, 3])
    t2 = time.perf_counter()
    if (pre.cycles, dec.cycles, dec.metrics.hit_rate) != \
            (ORACLE_PREFILL_CYCLES, ORACLE_DECODE_CYCLES,
             ORACLE_DECODE_HIT_RATE):
        raise AssertionError(f"oracle: prefill {pre.cycles}, decode "
                             f"{dec.cycles} (hit rate "
                             f"{dec.metrics.hit_rate})")
    print(f"oracle anchors equal: prefill_step {pre.cycles} cycles "
          f"({t1 - t0:.2f} s), decode_step {dec.cycles} cycles, hit rate "
          f"{dec.metrics.hit_rate} ({t2 - t1:.2f} s)")

    # first-token logits: the kernel's prefill against the plain SSD step
    first = {f["rid"]: f["tokens"][0] for f in eng.finished}
    worst = ssd_worst = 0.0
    kernel_op = ssd_ops.ssd_intra_chunk
    for rids in groups:
        batch = {"tokens": torch.as_tensor(
            [list(by_rid[r].tokens) for r in rids], device=dev)}
        operands = []

        def capture(*args, **kw):
            operands.append((args, kw))
            return kernel_op(*args, **kw)

        ssd_ops.ssd_intra_chunk = capture
        try:
            got, _, _ = prefill(params, batch, cfg, 552)
        finally:
            ssd_ops.ssd_intra_chunk = kernel_op
        # the kernel on this prefill's own operands, layer by layer
        for args, kw in operands:
            y, states, cum = kernel_op(*args, **kw)
            want_y, want_states, want_cum = ssd_ops.ssd_intra_chunk_plain(
                *args, **kw)
            torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
            torch.testing.assert_close(y, want_y, **SSD_TOL)
            torch.testing.assert_close(states, want_states, **SSD_TOL)
            ssd_worst = max(ssd_worst, max_err(y, want_y),
                            max_err(states, want_states))
        ssd_ops.ssd_intra_chunk = ssd_ops.ssd_intra_chunk_plain
        try:
            want, _, _ = prefill(params, batch, cfg, 552)
        finally:
            ssd_ops.ssd_intra_chunk = kernel_op
        got_first = got[:, :cfg.vocab_size].argmax(dim=1).tolist()
        if got_first != [first[r] for r in rids]:
            raise AssertionError(f"group {rids}: first tokens "
                                 f"{got_first} differ from the engine's")
        torch.testing.assert_close(got, want, **LOGITS_TOL)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"group {rids}: logits not finite")
        worst = max(worst, max_err(got[:, :cfg.vocab_size],
                                   want[:, :cfg.vocab_size]))
    print(f"first-token logits of {len(groups)} prefill groups, kernel vs "
          f"plain SSD step: max abs err {worst:.3e} (bf16 model; "
          f"tolerance {LOGITS_TOL})")
    print(f"ssd kernel vs plain on the {cfg.num_layers} layers' operands of "
          f"each of the {len(groups)} prefill groups: max abs err "
          f"{ssd_worst:.3e} (tolerance {SSD_TOL})")

    split = {"wall_s": wall, "model_s": eng.wall_s["model"],
             "oracle_s": eng.wall_s["oracle"],
             "oracle_prefill_s": t1 - t0, "oracle_decode_s": t2 - t1,
             "logits_max_abs_err": worst, "ssd_max_abs_err": ssd_worst}
    kinds = {"ssd": "ssd_"}
    caches = param_values(init_caches(cfg, 4, 552, device=dev))
    toks = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    ts = torch.full((4,), 512, dtype=torch.int64, device=dev)
    one = {"tokens": torch.as_tensor([list(requests[0].tokens)],
                                     device=dev)}
    fresh = SoCLatencyOracle(decode_working_set(cfg), device=dev)
    # the first profiled call of a process pays the tracer's start-up
    # (~10 s on the card); keep it out of the measured splits
    device_split(lambda: torch.ones(1, device=dev).sum(), kinds)
    profiled = {
        "prefill_1x512": device_split(
            lambda: prefill(params, one, cfg, 552), kinds),
        "decode_step_4_slots": device_split(
            lambda: slot_decode_step(params, caches, toks, ts, cfg), kinds),
        "oracle_decode_step": device_split(
            lambda: fresh.decode_step(kv, [0, 1, 2, 3]), kinds)}
    for name, sp in profiled.items():
        busy = sp["ssd"] + sp["other"]
        print(f"{name}: wall {sp['wall_ms']:.2f} ms, device busy "
              f"{busy:.3f} ms ({busy / sp['wall_ms']:.1%}; ssd "
              f"{sp['ssd']:.3f} ms)" if busy else
              f"{name}: wall {sp['wall_ms']:.2f} ms, device time not "
              "measured (no device events in the trace)")
    split["profiled"] = profiled
    return launches, split


def time_ssd(dev) -> dict:
    """The SSD kernel at the serving path's full width (4 prompts of 512
    tokens: 8 chunks of 256, 24 heads, p 64, n 128) beside its plain
    version and its bound."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops, ref

    bb, l, chunk, h, p, n = SSD_SHAPES[3]
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, A, B, C = ssd_inputs(bb, l, h, p, n, gen, dev)
    xc, dtc, cum, bc, cc = ops._chunked(x, dt, A, B, C, chunk)
    nc, q = xc.shape[1], xc.shape[2]
    out = {"ms": cuda_ms(lambda: K.ssd_intra_chunk_kernel(xc, dtc, cum, bc,
                                                          cc), 50),
           "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(
               xc, dtc, cum, bc, cc), 20),
           "library_ms": None}
    # FLOPs the masked function needs: the causal (l >= s) pairs of C.B^T
    # (once per chunk) and of scores @ x, ~5 a pair per head for the
    # decay and mask, and the per-head state product B^T (w x)
    pairs = q * (q + 1) // 2
    flops = bb * nc * (2 * pairs * n + h * (2 * pairs * p + 5 * pairs
                                            + 2 * q * n * p))
    # the TPU kernel's own count (the full q x q), printed for comparison
    full_flops = bb * nc * (2 * q * q * n + h * (2 * q * q * p + 5 * q * q
                                                 + 2 * q * n * p))
    nbytes = 4 * bb * nc * (2 * q * h * p + h * n * p + 2 * q * n
                            + 2 * q * h)
    out["bound_ms"] = max(flops / FP32_OPS_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / FP32_OPS_PER_S >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"ssd {bb}x{nc} chunks of {q}, h {h}, p {p}, n {n}: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, no library "
          f"call computes it, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {flops / 1e6:.0f} MFLOP causal, "
          f"{nbytes / 1e6:.1f} MB; the TPU kernel's full q x q count "
          f"{full_flops / 1e6:.0f} MFLOP would give "
          f"{full_flops / FP32_OPS_PER_S * 1e3:.4f} ms)")
    return out


def int_mm_ms(patches, wmat, reps):
    """torch._int_mm on the same GEMM (K and N padded to multiples of
    8, as it requires), or None where it refuses the operands."""
    k, n = wmat.shape
    kp, np_ = k + (-k) % 8, n + (-n) % 8
    a = torch.nn.functional.pad(patches, (0, kp - k)).contiguous()
    b = torch.nn.functional.pad(wmat, (0, np_ - n, 0, kp - k)).contiguous()
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, bb)
        except RuntimeError as e:
            err = e
            continue
        return cuda_ms(lambda: torch._int_mm(a, bb), reps)
    print(f"  torch._int_mm refused {tuple(a.shape)} @ {tuple(b.shape)}: "
          f"{str(err).splitlines()[0]}")
    return None


def time_kernels(dev) -> tuple[dict, list]:
    """Per-kernel device times at the main path's shapes: convcore summed
    over a frame's 75 convs (GEMM on prebuilt im2col patches), postproc
    on the stage's 208 x 208 x 64 map."""
    from repro_torch.kernels.convcore import matmul_int8
    from repro_torch.kernels.convcore.ops import im2col
    from repro_torch.kernels.convcore.ref import matmul_int8_ref
    from repro_torch.kernels.postproc import postprocess
    from repro_torch.kernels.postproc.ref import postprocess_ref

    phase("timing (CUDA events, after warm-up)")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, lib_missing = [], False
    for l in frame_layers():
        x, w, scale, bias = frame_inputs(l, gen, dev)
        patches, _ = im2col(x, l.ksize, l.ksize, stride=l.stride,
                            padding=l.ksize // 2)
        wmat = w.reshape(-1, l.cout)
        m, k = patches.shape
        n = l.cout
        kw = dict(relu=True, out_dtype=torch.float32)
        ms = cuda_ms(lambda: matmul_int8(patches, wmat, scale, bias, **kw),
                     5)
        plain = cuda_ms(
            lambda: matmul_int8_ref(patches, wmat, scale, bias, **kw), 2, 1)
        lib = int_mm_ms(patches, wmat, 5)
        lib_missing |= lib is None
        ops_s = 2 * m * n * k / INT8_OPS_PER_S
        bytes_s = (m * k + k * n + 8 * n + 4 * m * n) / HBM_BYTES_PER_S
        rows.append({"layer": l.index, "m": m, "k": k, "n": n, "ms": ms,
                     "plain_ms": plain, "library_ms": lib,
                     "ops_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3})
    cc = {"ms": sum(r["ms"] for r in rows),
          "plain_ms": sum(r["plain_ms"] for r in rows),
          "library_ms": None if lib_missing
          else sum(r["library_ms"] for r in rows),
          "bound_ms": sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows)}
    by_ops = sum(r["ops_ms"] for r in rows if r["ops_ms"] >= r["bytes_ms"])
    cc["bound_by"] = "operations" if by_ops >= cc["bound_ms"] / 2 \
        else "bytes"
    heavy = max(rows, key=lambda r: r["m"] * r["n"] * r["k"])
    print(f"convcore per frame (75 convs): kernel {cc['ms']:.3f} ms, plain "
          f"{cc['plain_ms']:.3f} ms, torch._int_mm {cc['library_ms']} ms, "
          f"bound {cc['bound_ms']:.3f} ms ({cc['bound_by']})")
    print(f"  heaviest, layer {heavy['layer']} {heavy['m']}x{heavy['k']}x"
          f"{heavy['n']}: kernel {heavy['ms']:.4f} ms, _int_mm "
          f"{heavy['library_ms']} ms, bound "
          f"{max(heavy['ops_ms'], heavy['bytes_ms']):.4f} ms")

    n_, h, w, c = 1, 208, 208, 64
    x = torch.randn((n_, h, w, c), generator=gen, device=dev)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    kw = dict(act="none", pool=2)
    xc = x.permute(0, 3, 1, 2)          # channels_last view, no copy
    pp = {"ms": cuda_ms(lambda: postprocess(x, ones, zeros, **kw), 50),
          "plain_ms": cuda_ms(lambda: postprocess_ref(x, ones, zeros, **kw),
                              20),
          # unit scale, zero bias, no activation: max-pool is the same
          # function on these inputs
          "library_ms": cuda_ms(
              lambda: torch.nn.functional.max_pool2d(xc, 2), 50)}
    out_bytes = n_ * (h // 2) * (w // 2) * c * 2        # bf16 output
    pp_bytes = n_ * h * w * c * 4 + out_bytes + 8 * c
    pp_ops = n_ * h * w * c * 3                         # mul, add, max
    pp["bound_ms"] = max(pp_bytes / HBM_BYTES_PER_S,
                         pp_ops / FP32_OPS_PER_S) * 1e3
    pp["bound_by"] = "bytes" if pp_bytes / HBM_BYTES_PER_S >= \
        pp_ops / FP32_OPS_PER_S else "operations"
    print(f"postproc {n_}x{h}x{w}x{c} pool 2: kernel {pp['ms']:.4f} ms, "
          f"plain {pp['plain_ms']:.4f} ms, max_pool2d "
          f"{pp['library_ms']:.4f} ms, bound {pp['bound_ms']:.4f} ms "
          f"({pp['bound_by']})")
    return {"convcore": cc, "postproc": pp}, rows


def device_split(fn, kinds=None) -> dict:
    """Wall time of ``fn`` and the device time of the kernels it
    launches, by kind (name -> substring of the kernel's name), from a
    torch.profiler trace (ms; the wall time includes the profiler's own
    cost)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = kinds or {"convcore": "matmul_int8_kernel",
                      "postproc": "postproc_kernel"}
    split = {"wall_ms": (time.perf_counter() - t0) * 1e3, "other": 0.0,
             **{k: 0.0 for k in kinds}}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = next((k for k, sub in kinds.items() if sub in e.name),
                        "other")
            split[kind] += e.device_time_total / 1e3
    return split


def where_time_goes(dev) -> dict:
    """Device busy time against wall time for a frame's 75 convs through
    ``conv2d_int8`` and for the simulated frame's segment-lane replay."""
    from repro_torch.core.soc import run_yolov3
    from repro_torch.kernels.convcore import conv2d_int8

    phase("where the time goes (torch.profiler)")
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [(l, *frame_inputs(l, gen, dev)) for l in frame_layers()]

    def frame():
        for l, x, w, scale, bias in inputs:
            conv2d_int8(x, w, scale, bias, stride=l.stride,
                        padding=l.ksize // 2, relu=True,
                        out_dtype=torch.float32)

    frame()
    out = {"frame_convs": device_split(frame),
           "simulated_frame": device_split(
               lambda: run_yolov3(mode="simulated", device=dev))}
    for name, split in out.items():
        busy = split["convcore"] + split["postproc"] + split["other"]
        if busy == 0.0:
            print(f"{name}: wall {split['wall_ms']:.2f} ms, device time "
                  "not measured (no device events in the trace)")
            continue
        print(f"{name}: wall {split['wall_ms']:.2f} ms, device busy "
              f"{busy:.3f} ms ({busy / split['wall_ms']:.1%}): convcore "
              f"{split['convcore']:.3f}, postproc {split['postproc']:.3f}, "
              f"other kernels {split['other']:.3f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = setup()
    errs = check_kernels(dev)
    errs["ssd"] = check_ssd(dev)
    res, launches, main_errs = main_path(dev)
    engine_times = paper_chain(res, dev)
    serve_launches, serve = serve_path(dev)
    launches["ssd"] = serve_launches["ssd"]
    main_errs["ssd"] = serve["ssd_max_abs_err"]
    timed, rows = time_kernels(dev)
    timed["ssd"] = time_ssd(dev)
    profiled = where_time_goes(dev)

    meta = {
        "convcore": ("src/repro_torch/csrc/convcore.cu",
                     "src/repro/kernels/convcore/kernel.py:62"),
        "postproc": ("src/repro_torch/csrc/postproc.cu",
                     "src/repro/kernels/postproc/kernel.py:50"),
        "ssd": ("src/repro_torch/csrc/ssd.cu",
                "src/repro/kernels/ssd/kernel.py:60"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        tm = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], main_errs[name]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']} {key} = {k[key]!r}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "convcore_layers": rows,
         "engine_wall_s": engine_times, "profiled": profiled,
         "serve": serve}, indent=1))
    print(f"\nchip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

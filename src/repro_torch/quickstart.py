"""Quickstart: the three things this framework does — the twin of the
reference's ``examples/quickstart.py``, with ``--device``.

1. reproduce the paper's headline result (NVDLA running YOLOv3 behind a
   shared LLC: fps, LLC block-size effect, co-runner interference);
2. train a small LM with the production train step (any of the ten
   assigned architectures — here qwen2's reduced config);
3. serve it with batched prefill+decode.

The model trains and serves on ``--device`` (``cuda`` unless asked
otherwise; attention through the swa forward and backward kernels
there).  Weights are random from seed 0 (``torch.Generator``), so the
losses and generated tokens differ from the reference's; the paper
numbers are the same closed-form model and equal the reference's.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import interference_sweep, llc_sweep, run_yolov3
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.types import param_values
from repro_torch.utils.env import default_device


def paper_experiments() -> dict:
    """The paper's three experiments; returns their numbers."""
    print("== paper: NVDLA + RISC-V SoC on FireSim ==")
    r = run_yolov3()
    print(f"YOLOv3-416: accel {r.accel_s*1e3:.1f} ms + cpu {r.cpu_s*1e3:.1f} ms"
          f" -> {r.fps:.2f} fps   (paper: 67 ms + 66 ms -> 7.5 fps)")
    sw = llc_sweep(sizes_kib=(1024,), blocks=(32, 64, 128))
    sp = {b: sw["grid"][(1024, b)] for b in (32, 64, 128)}
    print(f"LLC 1 MiB speedup by block size: 32B {sp[32]:.2f}x  "
          f"64B {sp[64]:.2f}x  128B {sp[128]:.2f}x   (paper: 1.01/1.25/1.51)")
    isw = interference_sweep(corunners=(0, 4))
    print(f"4 BwWrite co-runners: LLC-WSS {isw['llc'][4]:.2f}x, "
          f"DRAM-WSS {isw['dram'][4]:.2f}x slowdown  (paper: 2.1x / 2.5x)")
    return {"fps": r.fps, "accel_s": r.accel_s, "cpu_s": r.cpu_s,
            "llc_1mib": sp, "llc_x4": isw["llc"][4],
            "dram_x4": isw["dram"][4]}


def train_small_lm(steps: int = 20, device=None):
    """``steps`` AdamW steps of qwen2's reduced config; returns (cfg,
    state, losses)."""
    print("\n== train: qwen2 (reduced) ==")
    dev = default_device(device)
    cfg = get_smoke_config("qwen2-0.5b")
    params = param_values(init_params(0, cfg, device=dev))
    state = init_train_state(params)
    step_fn = make_train_step(
        cfg, AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100))
    stream = SyntheticStream(cfg, global_batch=4, seq_len=64, device=dev)
    losses = []
    for i in range(steps):
        state, m = step_fn(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
        if i % 5 == 0:
            print(f"  step {i:3d}  loss {losses[-1]:.3f}")
    return cfg, state, losses


def serve_small_lm(cfg, state, device=None):
    """Four requests through the continuous-batching engine; returns its
    stats."""
    print("\n== serve: continuous batching on the simulated SoC clock ==")
    eng = ServeEngine(cfg, state.params, cache_len=128, max_slots=2,
                      eos_id=0, device=default_device(device))
    rng = np.random.default_rng(7)
    for i in range(4):
        eng.submit(Request(
            rid=i, tokens=tuple(int(t) for t in
                                rng.integers(3, cfg.vocab_size, 32)),
            max_new=16, arrival_s=i * 1e-4))
    with torch.no_grad():
        stats = eng.run()
    print(f"  served {stats.requests} requests / {stats.tokens} tokens "
          f"in {stats.steps} steps")
    print(f"  simulated: {stats.tokens_per_s:.0f} tok/s, "
          f"p50 {stats.latency_p50_s * 1e3:.3f} ms, "
          f"p99 {stats.latency_p99_s * 1e3:.3f} ms, "
          f"peak occupancy {stats.max_occupancy}")
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    paper_experiments()
    cfg, state, _ = train_small_lm(device=dev)
    serve_small_lm(cfg, state, device=dev)
    print("\nquickstart complete.")


if __name__ == "__main__":
    main()

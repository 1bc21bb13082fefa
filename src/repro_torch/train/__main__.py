"""End-to-end training with fault tolerance — the twin of the
reference's ``examples/train_lm.py``, with the same flags plus
``--device``.

Presets:
* ``--preset smoke``  (default) — reduced model, quick on the CPU;
* ``--preset 100m``   — a ~100M-param qwen2-family model;
* ``--arch <id>`` / ``--full-config`` — any of the ten archs, reduced or
  at its full published size.

Deterministic resumable data, atomic checkpoints, a watchdog/straggler
log and an optional simulated failure.  The model trains on
``--device`` (``cuda`` unless asked otherwise; attention through the
swa forward and backward kernels there, SSM layers through the ssd
forward and backward kernels).

Run:  PYTHONPATH=src python -m repro_torch.train [--device cpu] [--steps 30]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.optim import AdamWConfig
from repro_torch.utils.env import default_device


def preset_100m() -> ModelConfig:
    return ModelConfig(
        name="qwen2-100m", family="dense", num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_000, attn_bias=True, act="silu", gated_mlp=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train")
    ap.add_argument("--preset", choices=("smoke", "100m"), default="smoke")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) arch config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--inject-failure", type=int, default=-1,
                    help="raise a simulated node failure at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.preset == "100m":
        cfg = preset_100m()
        args.batch, args.seq = max(args.batch, 8), max(args.seq, 256)
    elif args.full_config:
        cfg = get_config(args.arch)
    else:
        cfg = get_smoke_config(args.arch)

    loop_cfg = LoopConfig(total_steps=args.steps,
                          checkpoint_every=max(5, args.steps // 4),
                          checkpoint_dir=args.ckpt_dir, async_save=True,
                          log_every=max(1, args.steps // 20))

    def failure_hook(step):
        if step == args.inject_failure:
            args.inject_failure = -1
            raise RuntimeError(f"injected failure at step {step}")

    dev = default_device(args.device)
    res = train(cfg, AdamWConfig(lr=3e-3, warmup_steps=10,
                                 decay_steps=max(100, args.steps)),
                loop_cfg, global_batch=args.batch, seq_len=args.seq,
                failure_hook=failure_hook if args.inject_failure >= 0 else None,
                device=dev)
    print(f"\narch={cfg.name}  device={dev}")
    print(f"final loss {res.losses[-1]:.4f} after {len(res.losses)} steps "
          f"({res.restarts} restarts, {len(res.straggler_steps)} straggler "
          f"events)")


if __name__ == "__main__":
    main()

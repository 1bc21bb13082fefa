"""Fault-tolerant training loop: checkpoint/restart, watchdog, stragglers
(the reference's ``repro.train.loop``).

* **checkpoint/restart** — periodic atomic checkpoints via
  ``CheckpointManager``; on (re)start the loop resumes from the latest
  committed step, and the deterministic data stream replays the exact
  batch sequence, so a restarted run reproduces an unfailed one (the
  step sums every gradient in a fixed order: the embedding's backward
  sorts its tokens and the attention backward kernel uses no atomics).
* **failure injection** — ``failure_hook(step)`` raises to simulate a
  node loss; the loop catches, restores, and continues (bounded
  retries).
* **straggler watchdog** — per-step wall time is tracked against an EMA;
  steps slower than ``straggler_factor`` x the EMA are recorded and
  logged.
* **device** — the model trains on ``device`` (``cuda`` unless asked
  otherwise); ``float(loss)`` ends each step, the step barrier.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.models import init_params
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import TrainState, init_train_state, make_train_step
from repro_torch.types import param_values
from repro_torch.utils.env import default_device


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep: int = 3
    async_save: bool = True
    max_restarts: int = 3
    straggler_factor: float = 2.0
    log_every: int = 10
    microbatches: int = 1


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    losses: list
    straggler_steps: list
    restarts: int


def _run_segment(state, stream, step_fn, loop_cfg, manager, losses,
                 straggler_steps, failure_hook, log) -> TrainState:
    ema = None
    start = int(state.step)
    for step in range(start, loop_cfg.total_steps):
        if failure_hook is not None:
            failure_hook(step)  # may raise to simulate a node failure
        batch = stream.batch_at(step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # blocks; acts as the step barrier
        dt = time.perf_counter() - t0
        losses.append(loss)
        if ema is None:
            ema = dt
        elif dt > loop_cfg.straggler_factor * ema:
            straggler_steps.append((step, dt, ema))
            log(f"[watchdog] step {step} took {dt*1e3:.1f} ms "
                f"(> {loop_cfg.straggler_factor:.1f}x EMA {ema*1e3:.1f} ms)")
        ema = 0.9 * ema + 0.1 * dt if ema else dt
        if step % loop_cfg.log_every == 0:
            log(f"step {step:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f} ms")
        if (step + 1) % loop_cfg.checkpoint_every == 0:
            manager.save(state, step + 1)
    return state


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, loop_cfg: LoopConfig, *,
          global_batch: int, seq_len: int, seed: int = 0,
          failure_hook: Callable[[int], None] | None = None,
          log: Callable[[str], None] = print, device=None) -> LoopResult:
    """Run (or resume) training on ``device`` (``cuda`` when None);
    survives ``failure_hook`` exceptions."""
    dev = default_device(device)
    stream = SyntheticStream(cfg, global_batch, seq_len, seed=seed,
                             device=dev)
    step_fn = make_train_step(cfg, opt_cfg,
                              microbatches=loop_cfg.microbatches)
    manager = CheckpointManager(loop_cfg.checkpoint_dir, keep=loop_cfg.keep,
                                async_save=loop_cfg.async_save)

    def fresh_state() -> TrainState:
        return init_train_state(param_values(init_params(seed, cfg,
                                                         device=dev)))

    state = fresh_state()
    try:
        state = manager.restore_latest(state)
        log(f"resumed from step {int(state.step)}")
    except FileNotFoundError:
        pass

    losses: list = []
    straggler_steps: list = []
    restarts = 0
    while True:
        try:
            state = _run_segment(state, stream, step_fn, loop_cfg, manager,
                                 losses, straggler_steps, failure_hook, log)
            break
        except RuntimeError as e:  # simulated node failure
            restarts += 1
            if restarts > loop_cfg.max_restarts:
                raise
            log(f"[failure] {e}; restart {restarts}/{loop_cfg.max_restarts}")
            state = None   # freed before a fresh one is allocated
            state = fresh_state()
            try:
                state = manager.restore_latest(state)
                log(f"restored step {int(state.step)}")
            except FileNotFoundError:
                log("no checkpoint yet; restarting from scratch")
    manager.wait()
    return LoopResult(state=state, losses=losses,
                      straggler_steps=straggler_steps, restarts=restarts)

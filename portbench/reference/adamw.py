"""AdamW as the configurations state it: a frozen copy of the rules of
the port's ``repro_torch/train/optim.py``.

Global-norm clipping to ``grad_clip``; linear warm-up over
``warmup_steps`` then cosine decay to ``min_lr_ratio`` of ``lr`` at
``decay_steps``; bias-corrected moments; decoupled weight decay on
every leaf of two or more axes as held (the stacked norm scales too);
all in float32.
"""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, count: int) -> float:
    warm = min(count / max(1, opt["warmup_steps"]), 1.0)
    t = min(max((count - opt["warmup_steps"])
                / max(1, opt["decay_steps"] - opt["warmup_steps"]), 0.0),
            1.0)
    frac = opt["min_lr_ratio"] + (1.0 - opt["min_lr_ratio"]) * 0.5 * (
        1.0 + math.cos(math.pi * t))
    return opt["lr"] * warm * frac


@torch.no_grad()
def step(opt: dict, params: dict, grads: dict, m: dict, v: dict,
         count: int) -> dict:
    """One update of ``params``, ``m`` and ``v`` in place (``count`` the
    step number from 1); returns the clipped gradients."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = min(opt["grad_clip"] / max(float(norm), 1e-9), 1.0)
    lr = lr_at(opt, count)
    b1, b2 = opt["b1"], opt["b2"]
    clipped = {}
    for k, p in params.items():
        g = grads[k] * scale
        clipped[k] = g
        m[k].mul_(b1).add_(g, alpha=1.0 - b1)
        v[k].mul_(b2).add_(g.square(), alpha=1.0 - b2)
        upd = (m[k] / (1.0 - b1 ** count)) / (
            (v[k] / (1.0 - b2 ** count)).sqrt() + opt["eps"])
        if p.dim() >= 2:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    return clipped

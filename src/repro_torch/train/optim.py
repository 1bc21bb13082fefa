"""AdamW + warmup/cosine schedule + global-norm clipping (the
reference's ``repro.train.optim``, its rules kept rather than
``torch.optim.AdamW``'s).

Moments are fp32 whatever the parameter dtype (fp32 optimizer state);
the schedule and the bias corrections are computed in fp32 from the
step ``count``; all update math is fp32 with a final cast back to the
parameter dtype; weight decay applies only where ``p.ndim >= 2`` — in
the stacked ``layers`` layout the norm scales are 2-D and are decayed,
as in the reference.  Leaves are walked in the reference's order
(``types.tree_flatten``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.types import (
    global_norm,
    tree_flatten,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> dict:
    """fp32 zero moments shaped (and, for DTensors, placed) like
    ``params`` and an int32 count."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    leaves = tree_flatten(params)[0]
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping, fp32)."""
    flat, treedef = tree_flatten(grads)
    gnorm = global_norm(flat)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_unflatten(treedef, [g * scale.to(g.dtype) for g in flat]), \
        gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state: dict, params):
    """Returns (new_params, new_opt_state, metrics {"grad_norm", "lr"});
    the inputs are not modified."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf

    def upd(g, m, v, p):
        gf = g.to(torch.float32)
        m_new = cfg.b1 * m + (1.0 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1.0 - cfg.b2) * gf.square()
        step = (m_new / b1c) / ((v_new / b2c).sqrt() + cfg.eps)
        if p.dim() >= 2:   # decay matrices only (skip norms/biases)
            step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m_new, v_new

    flat_p, treedef = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_flatten(t)[0] for t in (
        grads, opt_state["m"], opt_state["v"]))
    new = [upd(g, m, v, p) for g, m, v, p in zip(flat_g, flat_m, flat_v,
                                                  flat_p)]
    new_params, new_m, new_v = (tree_unflatten(treedef, [n[i] for n in new])
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "count": count}, {
        "grad_norm": gnorm, "lr": lr}

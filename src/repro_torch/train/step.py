"""Microbatched train step with optional int8 gradient compression (the
reference's ``repro.train.step``).

``make_train_step`` builds the step function:

* microbatching — the global batch is split into ``microbatches`` chunks
  and their gradients are accumulated in fp32, each divided by the
  count, as the reference's ``lax.scan`` body does; metrics are the
  mean over the chunks;
* the model forward remats at layer-group boundaries (``cfg.remat``);
* optional gradient compression (``train.compress``) applies the int8 +
  error-feedback codec before the optimizer.

Gradients come from ``torch.autograd.grad`` on detached copies of the
parameter leaves, so no ``.grad`` is left behind; the new parameters
are leaf tensors that require gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import loss_fn
from repro_torch.sharding import logical_constraint
from repro_torch.train import compress as compress_mod
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.types import tree_flatten, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor
    ef: Any | None = None  # error-feedback buffers (grad compression)


def init_train_state(params, *, compress: bool = False) -> TrainState:
    """Parameters (made leaves that require gradients), fresh AdamW
    state, step 0 (int32) and, with ``compress``, fp32 zero error
    feedback."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params) \
        if compress else None
    dev = tree_flatten(params)[0][0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      ef=ef)


def grads_of(params, batch: dict, cfg: ModelConfig):
    """(grads, metrics) of ``loss_fn`` at ``params``: grads in the
    parameters' tree and dtypes, metrics detached."""
    flat, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(treedef, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return tree_unflatten(treedef, list(grads)), \
        {k: v.detach() for k, v in metrics.items()}


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of contiguous rows, as the reference splits
    them.  A DTensor batch is gathered whole once (DTensor cannot split
    a sharded dim unevenly) and each microbatch sharded over the batch
    axes again, so every device works on every microbatch."""
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"batch {b} not divisible by {n} microbatches"
        rest = (None,) * (x.dim() - 1)
        x = logical_constraint(x, None, *rest)
        return logical_constraint(x.reshape(n, b // n, *x.shape[1:]),
                                  None, "act_batch", *rest)

    chunks = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in chunks.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, compress_axis: str | None = None):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: dict):
        if microbatches > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            ms = []
            for one in _split_microbatches(batch, microbatches):
                g, m = grads_of(state.params, one, cfg)
                grads = tree_map(
                    lambda a, gi: a + gi.to(torch.float32) / microbatches,
                    grads, g)
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            grads, metrics = grads_of(state.params, batch, cfg)

        ef = state.ef
        if compress_axis is not None:
            grads, ef = compress_mod.compressed_reduce(
                grads, state.ef, axis=compress_axis)

        params, opt, opt_metrics = adamw_update(
            opt_cfg, grads, state.opt, state.params)
        params = tree_map(lambda p: p.requires_grad_(), params)
        metrics = {**metrics, **opt_metrics}
        return TrainState(params=params, opt=opt, step=state.step + 1,
                          ef=ef), metrics

    return train_step

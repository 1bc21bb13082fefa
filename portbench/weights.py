"""Initial weights from the seed, made on the device.

The leaves and their shapes are the reference family's
(``reference/<family>.py`` ``shapes``); how each leaf is drawn is the
configuration file's ``init`` list, a frozen copy of the port's
initialisers (``repro_torch/models/layers.py`` ``_dense_init``,
``init_norm``, ``init_embeddings``, ``init_mlp``; ``attention.py``
``init_attention``; ``ssm.py`` ``init_ssm``): the first rule whose
``match`` (a regular expression) matches the whole leaf path decides.

- ``normal``: N(0, 1) scaled by 1/sqrt of the product of the leaf's
  ``fan_dims`` (negative indices, so that a stacked leaf's leading
  layer axis never counts);
- ``ones``, ``zeros``;
- ``log_linspace``: log(linspace(low, high, n)) over the last axis.

Every ``normal`` leaf is a view of one fp32 buffer filled by a single
``normal_`` call of a generator on the device seeded with ``seed``, so
the same seed gives the same weights, and making them takes a few large
calls rather than one a leaf.
"""
from __future__ import annotations

import math
import re

import torch


def _rule(init: list[dict], path: str) -> dict:
    for rule in init:
        if re.fullmatch(rule["match"], path):
            return rule
    raise KeyError(f"no init rule matches the leaf {path!r}")


def make(shapes: dict[str, tuple], init: list[dict], seed: int,
         device) -> dict[str, torch.Tensor]:
    """{path: fp32 tensor on ``device``} for every leaf of ``shapes``."""
    device = torch.device(device)
    rules = {path: _rule(init, path) for path in shapes}
    normal = [p for p in shapes if rules[p]["init"] == "normal"]
    total = sum(math.prod(shapes[p]) for p in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, at = {}, 0
    for path, shape in shapes.items():
        rule = rules[path]
        kind = rule["init"]
        if kind == "normal":
            n = math.prod(shape)
            fan = math.prod(shape[d] for d in rule["fan_dims"])
            out[path] = flat[at:at + n].view(shape).mul_(
                1.0 / math.sqrt(max(1, fan)))
            at += n
        elif kind == "ones":
            out[path] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif kind == "log_linspace":
            row = torch.log(torch.linspace(rule["low"], rule["high"],
                                           shape[-1], device=device))
            out[path] = row.expand(shape).contiguous()
        else:
            raise ValueError(f"unknown init {kind!r} for {path!r}")
    return out

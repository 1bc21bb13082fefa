"""Int8 gradient compression with error feedback (the reference's
``repro.train.compress``).

    q     = round(g / scale),  scale = max|g| / 127   (per tensor)
    g_hat = sum(q) * mean(scale) / n                   (int8 on the wire)
    e'    = g + e - dequant(q)                          (error feedback)

Error feedback makes the compression unbiased over time: the
quantization residual is added back into the next step's gradient.

``compressed_reduce`` works in two contexts, as the reference's does:

* over a process group (``group=``, the reference's bound ``shard_map``
  axis): it all-reduces the int8 payload widened to int32, the scales
  and the count, and combines them with the reference's float32
  operations in its order, ``qsum * (ssum / n) / n``, so the result is
  bit-equal to the reference's ``psum``;
* without one (one card) it is the quantize/dequantize round trip with
  error feedback — the reference's numerics outside ``shard_map``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.types import tree_flatten, tree_unflatten


def quantize(g: torch.Tensor):
    """g -> (q int8, scale fp32 0-d)."""
    gf = g.to(torch.float32)
    amax = gf.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compressed_reduce(grads, ef, *, axis: str, group=None):
    """Error-feedback int8 reduction of a gradient tree over ``group``
    (a ``torch.distributed`` process group), or its round trip on one
    device when ``group`` is None.

    Returns (reduced grads fp32, new error feedback).  ``axis`` names
    the reduction axis as in the reference (the mesh axis ``group``
    spans)."""

    def one(g, e):
        gf = g.to(torch.float32) + (e if e is not None else 0.0)
        q, scale = quantize(gf)
        deq = dequantize(q, scale)
        if group is None:
            return deq, gf - deq
        # the int8 payload accumulated in int32, the scales, the count
        qsum = q.to(torch.int32)
        ssum = scale.clone()
        count = torch.ones((), dtype=torch.int32, device=q.device)
        for t in (qsum, ssum, count):
            dist.all_reduce(t, group=group)
        n = int(count)
        return qsum.to(torch.float32) * (ssum / n) / n, gf - deq

    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(ef)[0] if ef is not None else [None] * len(flat_g)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))

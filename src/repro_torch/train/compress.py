"""Int8 gradient compression with error feedback (the reference's
``repro.train.compress``).

    q     = round(g / scale),  scale = max|g| / 127   (per tensor)
    g_hat = dequant(q)
    e'    = g + e - dequant(q)                          (error feedback)

Error feedback makes the compression unbiased over time: the
quantization residual is added back into the next step's gradient.

On one card no reduction axis is bound, so ``compressed_reduce`` is the
quantize/dequantize round trip with error feedback — the reference's
numerics outside ``shard_map``.  The int8 all-reduce over a bound group
(the reference's ``psum`` of the int8 payload across pods) waits for the
sharding slice (ROADMAP, Queue 1, item 9): passing ``group`` raises.
"""
from __future__ import annotations

import torch

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
    """Error-feedback int8 round trip of a gradient tree.

    Returns (reduced grads fp32, new error feedback).  ``axis`` names
    the reduction axis as in the reference (unbound on one card);
    ``group`` — a process group to all-reduce the int8 payload over —
    is not supported yet."""
    if group is not None:
        raise NotImplementedError(
            f"compressed_reduce over a bound group (axis {axis!r}) waits "
            "for the sharding slice (ROADMAP, Queue 1, item 9: "
            "sharding/specs.py); on one card pass no group")

    def one(g, e):
        gf = g.to(torch.float32) + (e if e is not None else 0.0)
        q, scale = quantize(gf)
        deq = dequantize(q, scale)
        return deq, gf - deq

    flat_g, treedef = tree_flatten(grads)
    flat_e = tree_flatten(ef)[0] if ef is not None else [None] * len(flat_g)
    out = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))

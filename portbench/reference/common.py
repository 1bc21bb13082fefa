"""Pieces the plain references share: products, norms, the loss, and
the precision a reference computes in.

The reference computes in float32 (TF32 off: ``train.follow`` turns it
off on the card).  A configuration's control is the precision below
the one it computes in (its ``precision.control``): ``TF32`` for float32
with TF32 off, the products and convolutions on TF32 tensor cores;
``FP8`` for bfloat16, float8 as a float8 training recipe has it:
both operands of every weight product (the projections, the MLP, the
unembedding) rounded to e4m3; every activation the program holds in
its compute dtype (the embedding's rows, each product's output, the
mixer's and the MLP's outputs, the residual stream after each block)
rounded to e4m3, and the gradient that flows back through it to e5m2;
each float8 tensor under a per-tensor scale (its absolute maximum to
the format's largest finite value).  The weights' own gradients stay
float32, as the program's are.
"""
from __future__ import annotations

import torch

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)
BF16 = (torch.bfloat16, None)


def _round(x: torch.Tensor, fmt) -> torch.Tensor:
    dtype, top = fmt
    if top is None:
        return x.to(dtype).to(x.dtype)
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.bwd), None, None


class Precision:
    """Where a reference rounds, and to what: weight products' operands
    and activations to ``fwd``, the gradients flowing back through the
    activations to ``bwd`` (nowhere when ``fwd`` is None); with ``tf32``
    its float32 products and convolutions run on TF32 tensor cores."""

    def __init__(self, name: str, fwd=None, bwd=None, tf32: bool = False):
        self.name, self.fwd, self.bwd, self.tf32 = name, fwd, bwd, tf32

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.fwd is None else _Rounded.apply(x, self.fwd,
                                                          self.bwd)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` over w's first axis (``w`` (in, out)); the operands'
        gradients pass their rounding unrounded."""
        if self.fwd is not None:
            x = x + (_round(x.detach(), self.fwd) - x.detach())
            w = w + (_round(w.detach(), self.fwd) - w.detach())
        return self.act(x @ w)


FP32 = Precision("fp32")
FP8 = Precision("fp8", E4M3, E5M2)
TF32 = Precision("tf32", tf32=True)
# not a control: bfloat16 at the same points, to see how far rounding
# there alone moves the compared numbers (readings.py)
BF16_POINTS = Precision("bf16_points", BF16, BF16)
PRECISIONS = {p.name: p for p in (FP32, FP8, TF32, BF16_POINTS)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def nll_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum over positions of -log softmax(logits)[label]."""
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()

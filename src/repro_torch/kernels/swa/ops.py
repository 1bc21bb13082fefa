"""Public SWA attention op: (B, S, H, D) layout, GQA, ragged S.

``swa_attention`` is causal softmax attention over a band of ``window``
keys (``0 <= qpos - kpos < window``).  Tensors on a CUDA device go
through the Hopper kernel (``kernel.py``) — or raise; CPU tensors take
the plain version (``swa_attention_plain``), which runs on any device.
Neither expands the KV heads to the query heads in memory: query head
``h`` reads KV head ``h // (Hq // Hkv)``.

With gradients on and an operand that needs one, ``swa_attention``
runs as a ``torch.autograd.Function`` that saves q, k, v and the output
(and, on the card's tensor-core route, the rows' log-sum-exp that the
forward kernel writes) and recomputes the probabilities in the backward
pass (the flash-attention policy the reference writes as
``jax.checkpoint`` per query chunk): the backward kernel on the card,
the plain backward (``swa_attention_bwd_plain``) on the CPU.  The
backward is not itself differentiable (double backward raises), and
forward-mode AD is not offered: no path returns a result detached from
its inputs.

Meta tensors (the dry-run's trace, ``repro_torch.launch.dryrun``) take
a route of their own, forward and backward: outputs of the kernels'
shapes and dtypes, and a ``kernels.meta.record`` of the FLOPs and bytes
the kernels would spend on them; neither kernel nor plain version runs.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import meta
from repro_torch.kernels.swa import kernel as K
from repro_torch.kernels.swa.ref import NEG_INF

DEFAULT_BLOCK = 256     # query rows per chunk of the plain version


def _check(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("swa_attention takes q (B, S, Hq, D) and k/v "
                         f"(B, S, Hkv, D); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d \
            or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("swa_attention operands must share one device")


def swa_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int, scale: float | None = None,
                        softcap: float = 0.0,
                        block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The plain PyTorch version of ``swa_attention``, on the operands'
    own device: fp32 scores and softmax, query chunks of ``block`` rows
    that each read only their band of keys."""
    _check(q, k, v, window)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    pos = torch.arange(s, device=q.device)
    qf = q.to(torch.float32).reshape(b, s, hkv, g, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = []
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        j0 = max(0, i0 - window + 1)
        scores = torch.einsum("blkgd,btkd->bkglt", qf[:, i0:i1],
                              kf[:, j0:i1]) * scale
        if softcap > 0.0:
            scores = softcap * torch.tanh(scores / softcap)
        qp, kp = pos[i0:i1, None], pos[None, j0:i1]
        mask = (qp >= kp) & (qp - kp < window)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("bkglt,btkd->blkgd", probs, vf[:, j0:i1]))
    return torch.cat(out, dim=1).reshape(b, s, hq, d).to(q.dtype)


def swa_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, window: int,
                            scale: float | None = None, softcap: float = 0.0,
                            block: int = DEFAULT_BLOCK):
    """The plain PyTorch version of the backward kernel, on the
    operands' own device: (dq, dk, dv) of ``swa_attention``'s output
    ``o`` for the cotangent ``do``, in the operands' dtypes.  Query
    chunk by query chunk of ``block`` rows, in fp32: the chunk's scores
    and probabilities recomputed, ``dP = dO Vᵀ``, ``dS = P (dP - delta)``
    with ``delta = rowsum(dO * O)`` (times ``1 - tanh²`` of the capped
    score with a softcap), ``dQ = scale dS K``, and ``dK += scale dSᵀ Q``,
    ``dV += Pᵀ dO`` summed over each KV head's group of query heads."""
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    pos = torch.arange(s, device=q.device)
    f32 = torch.float32
    qf, of, dof = (t.to(f32).reshape(b, s, hkv, g, d) for t in (q, o, do))
    kf, vf = k.to(f32), v.to(f32)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)      # (b, hkv, g, s)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        j0 = max(0, i0 - window + 1)
        scores = torch.einsum("blkgd,btkd->bkglt", qf[:, i0:i1],
                              kf[:, j0:i1]) * scale
        if softcap > 0.0:
            t = torch.tanh(scores / softcap)
            scores = softcap * t
        qp, kp = pos[i0:i1, None], pos[None, j0:i1]
        mask = (qp >= kp) & (qp - kp < window)
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        dp = torch.einsum("blkgd,btkd->bkglt", dof[:, i0:i1], vf[:, j0:i1])
        ds = probs * (dp - delta[..., i0:i1, None])
        if softcap > 0.0:
            ds = ds * (1.0 - t * t)
        dq[:, i0:i1] = torch.einsum("bkglt,btkd->blkgd", ds,
                                    kf[:, j0:i1]) * scale
        dk[:, j0:i1] += torch.einsum("bkglt,blkgd->btkd", ds,
                                     qf[:, i0:i1]) * scale
        dv[:, j0:i1] += torch.einsum("bkglt,blkgd->btkd", probs,
                                     dof[:, i0:i1])
    return (dq.reshape(b, s, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _band_pairs(s: int, window: int) -> int:
    """(query, key) pairs in the causal band of ``window`` over ``s``
    positions: sum of min(i + 1, window) for i < s."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _forward(q, k, v, window, scale, softcap, block):
    if q.device.type == "meta":
        b, s, hq, d = q.shape
        meta.record("swa", 4 * d * _band_pairs(s, window) * hq * b,
                    q.element_size() * 2 * (q.numel() + k.numel()))
        return q.new_empty(q.shape)
    if q.device.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, scale=scale,
                                   softcap=softcap, block=block)
    return K.swa_attention_kernel(
        *(t.contiguous() for t in (q, k, v)), window=window, scale=scale,
        softcap=softcap)


class _SwaAttention(torch.autograd.Function):
    """``swa_attention`` with its backward pass: the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale, softcap, block):
        lse = None
        if q.device.type == "cuda" \
                and K.bwd_route(q.dtype, q.shape[-1]) == "tc":
            o, lse = K.swa_attention_kernel(
                *(t.contiguous() for t in (q, k, v)), window=window,
                scale=scale, softcap=softcap, with_lse=True)
        else:
            o = _forward(q, k, v, window, scale, softcap, block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, scale, softcap, block)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        window, scale, softcap, block = ctx.args
        if q.device.type == "cpu":
            grads = swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                            scale=scale, softcap=softcap,
                                            block=block)
        elif q.device.type == "meta":
            b, s, hq, d = q.shape
            meta.record("swa_bwd", 10 * d * _band_pairs(s, window) * hq * b,
                        q.element_size() * 4 * (q.numel() + k.numel()))
            grads = tuple(t.new_empty(t.shape) for t in (q, k, v))
        else:
            grads = K.swa_attention_bwd_kernel(
                *(t.contiguous() for t in (q, k, v, o, do)), window=window,
                scale=scale, softcap=softcap, lse=lse)
        return (*grads, None, None, None, None)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None,
                  softcap: float = 0.0,
                  block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Causal banded attention. q (B, S, Hq, D); k/v (B, S, Hkv, D) ->
    (B, S, Hq, D) in q's dtype; ``window >= S`` is full causal
    attention.  ``scale`` defaults to ``D ** -0.5``; ``softcap > 0``
    applies ``softcap * tanh(s / softcap)`` to the scores.  ``block`` is
    the query chunk of the plain versions (the CPU path); the kernels
    tile the queries their own way.  Differentiable in q, k and v (the
    backward kernel on the card)."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"swa_attention runs on cuda (kernel), cpu "
                         f"(plain version) or meta (shapes), not "
                         f"{dev.type}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _SwaAttention.apply(q, k, v, window, scale, softcap, block)
    return _forward(q, k, v, window, scale, softcap, block)

"""Public SWA attention op: (B, S, H, D) layout, GQA, ragged S.

``swa_attention`` is causal softmax attention over a band of ``window``
keys (``0 <= qpos - kpos < window``).  Tensors on a CUDA device go
through the Hopper kernel (``kernel.py``) — or raise; CPU tensors take
the plain version (``swa_attention_plain``), which runs on any device.
Neither expands the KV heads to the query heads in memory: query head
``h`` reads KV head ``h // (Hq // Hkv)``.
"""
from __future__ import annotations

import torch

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


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, scale: float | None = None,
                  softcap: float = 0.0,
                  block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Causal banded attention. q (B, S, Hq, D); k/v (B, S, Hkv, D) ->
    (B, S, Hq, D) in q's dtype; ``window >= S`` is full causal
    attention.  ``scale`` defaults to ``D ** -0.5``; ``softcap > 0``
    applies ``softcap * tanh(s / softcap)`` to the scores.  ``block`` is
    the query chunk of the plain version (the CPU path); the kernel
    tiles the queries its own way."""
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return swa_attention_plain(q, k, v, window=window, scale=scale,
                                   softcap=softcap, block=block)
    if dev.type != "cuda":
        raise ValueError(f"swa_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return K.swa_attention_kernel(
        *(t.contiguous() for t in (q, k, v)), window=window, scale=scale,
        softcap=softcap)

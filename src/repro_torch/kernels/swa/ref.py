"""Plain PyTorch oracle: causal, window-banded softmax attention."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int, scale: float | None = None,
                      softcap: float = 0.0) -> torch.Tensor:
    """q/k/v (BH, S, D) -> (BH, S, D); fp32 scores and softmax over the
    full (S, S) masked score matrix."""
    s, d = q.shape[1], q.shape[2]
    scale = scale if scale is not None else d ** -0.5
    scores = torch.einsum("bld,btd->blt", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & \
        (pos[:, None] - pos[None, :] < window)
    scores = torch.where(mask[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("blt,btd->bld", probs,
                        v.to(torch.float32)).to(q.dtype)

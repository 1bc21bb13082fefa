"""Plain PyTorch version of the fused post-processing pass."""
from __future__ import annotations

import torch


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp(x, min=0.0)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "tanh":
        return torch.tanh(x)
    return x


def postprocess_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, act: str = "relu", pool: int = 1,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H // pool, W // pool, C): scale, bias and
    activation in fp32, then the max over each pool x pool window (a
    ragged edge that fills no whole window is dropped)."""
    y = x.to(torch.float32) * scale + bias
    y = _act(y, act)
    if pool > 1:
        n, h, w, c = y.shape
        ho, wo = h // pool, w // pool
        y = y[:, :ho * pool, :wo * pool, :]
        y = y.reshape(n, ho, pool, wo, pool, c).amax(dim=(2, 4))
    return y.to(out_dtype)

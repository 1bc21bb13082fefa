"""Plain PyTorch version of the SSD intra-chunk computation (g == 1)."""
from __future__ import annotations

import torch


def ssd_intra_chunk_ref(x, dt, cum, B, C):
    """Same contract as the kernel: returns (y_intra, states)."""
    q = x.shape[2]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (bb,nc,l,s,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.tensor(-1e30, dtype=seg.dtype, device=x.device))
    decay = torch.exp(seg)
    cb = torch.einsum("bcln,bcsn->bcls", C, B)                # (bb,nc,l,s)
    scores = cb[:, :, :, :, None] * decay * dt[:, :, None, :, :]
    y = torch.einsum("bclsh,bcshp->bclhp", scores, x)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt               # (bb,nc,q,h)
    states = torch.einsum("bcsn,bcsh,bcshp->bchnp", B, w, x)
    return y, states

"""Plain PyTorch version of the SSD intra-chunk computation for one SSM
group (``ops.py`` runs it once per group)."""
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


def ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, gy, gst):
    """The gradients (gx, gdt, gcum, gB, gC) of ``ssd_intra_chunk_ref``'s
    (y, states) given their cotangents gy (bb, nc, q, h, p) and gst (bb,
    nc, h, n, p), in closed form and in the operands' dtype: with the
    forward's CB = C Bᵀ, E = exp(cum_l - cum_s) (l >= s, else 0), S = CB E
    dt_s and w = exp(cum_last - cum) dt, and dS = gy xᵀ (causal), U = B
    gst, r = rowsum(x U), P = dS S, Q = dS CB E:
    gx = Sᵀ gy + w U; gcum = rowsum(P) - colsum(P) - w r, plus sum(w r)
    at the last row; gdt = colsum(Q) + exp(cum_last - cum) r; gCB = sum_h
    dS E dt_s, gC = gCB B, gB = gCBᵀ C + sum_h (w x) gstᵀ."""
    q = x.shape[2]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    mask = causal[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (bb,nc,l,s,h)
    decay = torch.exp(torch.where(
        mask, seg, torch.tensor(-1e30, dtype=seg.dtype, device=x.device)))
    cb = torch.einsum("bcln,bcsn->bcls", C, B)                # (bb,nc,l,s)
    dts = dt[:, :, None, :, :]                                # dt_s
    ds = torch.einsum("bclhp,bcshp->bclsh", gy, x) * mask
    scores = cb[..., None] * decay * dts
    u = torch.einsum("bcsn,bchnp->bcshp", B, gst)
    ex = torch.exp(cum[:, :, -1:, :] - cum)                   # (bb,nc,q,h)
    w = ex * dt
    r = (x * u).sum(-1)
    gx = torch.einsum("bclsh,bclhp->bcshp", scores, gy) + w[..., None] * u
    qq = ds * cb[..., None] * decay
    pp = qq * dts
    gcum = pp.sum(3) - pp.sum(2) - w * r
    gcum[:, :, -1] += (w * r).sum(2)
    gdt = qq.sum(2) + ex * r
    gcb = (ds * decay * dts).sum(-1)                          # (bb,nc,l,s)
    gC = torch.einsum("bcls,bcsn->bcln", gcb, B)
    gB = torch.einsum("bcls,bcln->bcsn", gcb, C) \
        + torch.einsum("bcsh,bcshp,bchnp->bcsn", w, x, gst)
    return gx, gdt, gcum, gB, gC

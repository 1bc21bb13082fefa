"""Public SSD op: chunking plumbing around the intra-chunk kernel.

``ssd_intra_chunk`` mirrors the dataflow of
``repro_torch.models.ssm.ssd_chunked`` — the kernel owns the heavy
intra-chunk products; the caller composes the inter-chunk state scan
and the D-skip.  Tensors on a CUDA device go through the Hopper kernel
(``kernel.py``) — or raise; CPU tensors take the plain version
(``ssd_intra_chunk_plain``, over ``ref.py``), which runs on any device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref


def _chunked(x, dt, A, B, C, chunk: int):
    """(Bb, L, ...) operands -> fp32 (bb, nc, q, ...) chunks and the
    within-chunk decay prefix ``cum``."""
    if x.dim() != 4 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("ssd_intra_chunk takes x (Bb, L, H, P) and "
                         "single-group B/C (Bb, L, N) — more than one SSM "
                         f"group is not supported; got x {tuple(x.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    bb, l, h, p = x.shape
    n = B.shape[-1]
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd_intra_chunk operands must share one device")
    q = chunk if l % chunk == 0 and l > chunk else l
    nc = l // q
    xc = x.reshape(bb, nc, q, h, p).to(torch.float32)
    dtc = dt.reshape(bb, nc, q, h).to(torch.float32)
    cum = torch.cumsum(dtc * A.to(torch.float32)[None, None, None, :], dim=2)
    bc = B.reshape(bb, nc, q, n).to(torch.float32)
    cc = C.reshape(bb, nc, q, n).to(torch.float32)
    return xc, dtc, cum, bc, cc


def ssd_intra_chunk_plain(x, dt, A, B, C, *, chunk: int):
    """The plain PyTorch version of ``ssd_intra_chunk``, on the
    operands' own device."""
    xc, dtc, cum, bc, cc = _chunked(x, dt, A, B, C, chunk)
    y, states = ref.ssd_intra_chunk_ref(xc, dtc, cum, bc, cc)
    return y, states, cum


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x (Bb, L, H, P); dt (Bb, L, H) post-softplus; A (H,) negative;
    B/C (Bb, L, N) single-group.  Returns (y_intra (bb, nc, q, h, p),
    states (bb, nc, h, n, p), cum (bb, nc, q, h)), fp32, with cum the
    within-chunk decay prefix the inter-chunk scan needs."""
    dev = x.device
    if dev.type == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    xc, dtc, cum, bc, cc = _chunked(x, dt, A, B, C, chunk)
    y, states = K.ssd_intra_chunk_kernel(
        *(t.contiguous() for t in (xc, dtc, cum, bc, cc)))
    return y, states, cum

"""Public SSD op: chunking plumbing around the intra-chunk kernel.

``ssd_intra_chunk`` mirrors the dataflow of
``repro_torch.models.ssm.ssd_chunked`` — the kernel owns the heavy
intra-chunk products; the caller composes the inter-chunk state scan
and the D-skip.  Tensors on a CUDA device go through the Hopper kernel
(``kernel.py``) — or raise; CPU tensors take the plain version
(``ssd_intra_chunk_plain``, over ``ref.py``), which runs on any device.
With G > 1 SSM groups (B/C of shape (Bb, L, G, N)) group ``gi`` owns the
contiguous heads ``gi*H/G .. (gi+1)*H/G - 1`` (the reference's head
order); both take one call per group over its heads and concatenate the
results in head order.

Differentiable: where an operand needs a gradient, each group's call
runs as the autograd Function ``_SsdIntraChunk`` over the chunked fp32
operands (x, dt, cum, B, C), whose backward is the backward kernel
(``kernel.ssd_intra_chunk_bwd_kernel``) on the card and the closed-form
plain backward (``ref.ssd_intra_chunk_bwd_ref``) otherwise.  The
gradients of dt and A through ``cum = cumsum(dt * A)`` and of the
group slices and chunk reshapes are PyTorch autograd's.

Meta tensors (the dry-run's trace, ``repro_torch.launch.dryrun``) take
a route of their own, forward and backward: outputs of the kernels'
shapes and dtypes, and a ``kernels.meta.record`` of the FLOPs and bytes
the kernels would spend on them; neither kernel nor plain version runs.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import meta
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd import ref


def _chunked(x, dt, A, B, C, chunk: int):
    """One group's (Bb, L, ...) operands -> fp32 (bb, nc, q, ...) chunks
    and the within-chunk decay prefix ``cum``."""
    if x.dim() != 4 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("a group's SSD operands are x (Bb, L, H, P) and "
                         f"B/C (Bb, L, N); got x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's cp.async loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _per_group(step, x, dt, A, B, C, chunk: int):
    """``step`` over one group's operands, or once per group of grouped
    B/C (Bb, L, G, N) over that group's contiguous heads, the results
    concatenated in head order."""
    if B.dim() != 4:
        return step(x, dt, A, B, C, chunk)
    g, h = B.shape[2], x.shape[2]
    if C.shape != B.shape or h % g:
        raise ValueError(f"{h} heads do not split into B/C's {g} groups "
                         f"(B {tuple(B.shape)}, C {tuple(C.shape)})")
    hg = h // g
    outs = [step(x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
                 A[i * hg:(i + 1) * hg], B[:, :, i], C[:, :, i], chunk)
            for i in range(g)]
    y, states, cum = zip(*outs)
    return torch.cat(y, dim=3), torch.cat(states, dim=2), torch.cat(cum, 3)


def _meta_forward(xc, dtc, cum, bc, cc):
    """The kernel's outputs on meta operands, and its cost: the causal
    (l >= s) pairs of C.B^T once a chunk and of scores @ x, ~5 FLOP a
    pair and head for the decay and mask, the per-head state product
    (chip_smoke.py's ``time_ssd`` count); its operands read and outputs
    written once."""
    bb, nc, q, h, p = xc.shape
    n = bc.shape[-1]
    cells, pairs = bb * nc, q * (q + 1) // 2
    meta.record("ssd", cells * (2 * pairs * n + h * (
        2 * pairs * p + 5 * pairs + 2 * q * n * p)),
        4 * cells * (2 * q * h * p + h * n * p + 2 * q * n + 2 * q * h))
    return xc.new_empty(xc.shape), xc.new_empty((bb, nc, h, n, p))


def _meta_backward(xc, dtc, cum, bc, cc, gy, gst):
    """The backward kernel's gradients on meta operands, and its cost:
    the FLOPs its grids issue (``kernel.bwd_issued_flops``), its
    operands read and gradients written once."""
    bb, nc, q, h, p = xc.shape
    n = bc.shape[-1]
    cells = bb * nc
    meta.record("ssd_bwd", cells * K.bwd_issued_flops(q, h, p, n),
                4 * cells * (3 * q * h * p + 4 * q * h + 4 * q * n
                             + h * n * p))
    return tuple(t.new_empty(t.shape) for t in (xc, dtc, cum, bc, cc))


def _forward(operands, route: str):
    if route == "kernel":
        return K.ssd_intra_chunk_kernel(*(_aligned(t) for t in operands))
    if route == "meta":
        return _meta_forward(*operands)
    return ref.ssd_intra_chunk_ref(*operands)


class _SsdIntraChunk(torch.autograd.Function):
    """One group's intra-chunk step over its chunked fp32 operands (xc,
    dtc, cum, bc, cc) with its backward pass, by ``route``: the kernels
    (``"kernel"``), the plain versions (``"plain"``) or shapes and costs
    only (``"meta"``)."""

    @staticmethod
    def forward(ctx, xc, dtc, cum, bc, cc, route):
        ctx.save_for_backward(xc, dtc, cum, bc, cc)
        ctx.route = route
        return _forward((xc, dtc, cum, bc, cc), route)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gst):
        operands = (*ctx.saved_tensors, gy, gst)
        if ctx.route == "kernel":
            grads = K.ssd_intra_chunk_bwd_kernel(
                *(_aligned(t) for t in operands))
        elif ctx.route == "meta":
            grads = _meta_backward(*operands)
        else:
            grads = ref.ssd_intra_chunk_bwd_ref(*operands)
        return (*grads, None)


def _step(route: str):
    def step(x, dt, A, B, C, chunk):
        operands = _chunked(x, dt, A, B, C, chunk)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands):
            y, states = _SsdIntraChunk.apply(*operands, route)
        else:
            y, states = _forward(operands, route)
        return y, states, operands[2]
    return step


_plain_step, _kernel_step, _meta_step = \
    _step("plain"), _step("kernel"), _step("meta")


def _device_type(x: torch.Tensor) -> str:
    return x.device.type


def ssd_intra_chunk_plain(x, dt, A, B, C, *, chunk: int):
    """The plain PyTorch version of ``ssd_intra_chunk``, on the
    operands' own device."""
    return _per_group(_plain_step, x, dt, A, B, C, chunk)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x (Bb, L, H, P); dt (Bb, L, H) post-softplus; A (H,) negative;
    B/C (Bb, L, N) for one group or (Bb, L, G, N) for G groups (H a
    multiple of G; one kernel launch per group).  Returns (y_intra (bb,
    nc, q, h, p), states (bb, nc, h, n, p), cum (bb, nc, q, h)), fp32,
    with cum the within-chunk decay prefix the inter-chunk scan
    needs.  Differentiable in x, dt, A, B and C (the backward kernel on
    the card)."""
    dev = _device_type(x)
    if dev == "cpu":
        return ssd_intra_chunk_plain(x, dt, A, B, C, chunk=chunk)
    if dev == "meta":
        return _per_group(_meta_step, x, dt, A, B, C, chunk)
    if dev != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda (kernel), cpu "
                         f"(plain version) or meta (shapes), not {dev}")
    return _per_group(_kernel_step, x, dt, A, B, C, chunk)

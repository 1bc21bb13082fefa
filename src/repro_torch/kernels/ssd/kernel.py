"""Mamba-2 SSD intra-chunk step on Hopper: launch wrapper of
``repro_torch/csrc/ssd.cu`` (which says what bounds it and how it is
built).

The SSD decomposition splits the linear recurrence into dense
intra-chunk products — more than 95% of the FLOPs — and a cheap
inter-chunk state scan.  The kernel owns the first part: per (sequence,
chunk) it computes ``y_intra`` and the chunk's end state without the
(q, q) score matrix ever leaving the SM, every product in 3xTF32 on the
tensor cores and each C·Bᵀ tile shared by a group of heads; the scan
stays in PyTorch (``repro_torch.models.ssm.ssd_chunked``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0     # wrapper calls that launched the kernel, in this process


def smem_bytes() -> dict[str, int]:
    """Dynamic shared memory of the y and state kernels (bytes)."""
    lib = _build.library("ssd")
    lib.ssd_smem_bytes.restype = ctypes.c_int
    lib.ssd_smem_bytes.argtypes = [ctypes.c_int]
    return {"ssd_y_kernel": lib.ssd_smem_bytes(0),
            "ssd_state_kernel": lib.ssd_smem_bytes(1)}


def ssd_intra_chunk_kernel(x: torch.Tensor, dt: torch.Tensor,
                           cum: torch.Tensor, B: torch.Tensor,
                           C: torch.Tensor):
    """x (bb, nc, q, h, p); dt/cum (bb, nc, q, h); B/C (bb, nc, q, n);
    all fp32, contiguous, 16-byte aligned, on one CUDA device.

    Returns (y_intra (bb, nc, q, h, p), states (bb, nc, h, n, p)), fp32,
    launched on the current stream.  Single SSM group (g == 1)."""
    global launches
    tensors = (x, dt, cum, B, C)
    if x.device.type != "cuda" or any(
            t.device != x.device or not t.is_contiguous()
            or t.data_ptr() % 16 for t in tensors):
        raise ValueError("ssd_intra_chunk_kernel takes contiguous, 16-byte "
                         "aligned tensors on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_intra_chunk_kernel takes fp32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 5:
        raise ValueError(f"x must be (bb, nc, q, h, p), got {tuple(x.shape)}")
    bb, nc, q, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (bb, nc, q, h) or cum.shape != (bb, nc, q, h) \
            or B.shape != (bb, nc, q, n) or C.shape != (bb, nc, q, n):
        raise ValueError("ssd_intra_chunk_kernel shapes: x (bb, nc, q, h, "
                         "p), dt/cum (bb, nc, q, h), B/C (bb, nc, q, n); "
                         f"got {[tuple(t.shape) for t in tensors]}")
    y = torch.empty_like(x)
    states = torch.empty((bb, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0 or states.numel() == 0:
        return y, states
    lib = _build.library("ssd")
    fn = lib.ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (x, dt, cum, B, C, y, states)),
             bb * nc, q, h, p, n, stream)
    _build.check(lib, "ssd", err)
    launches += 1
    return y, states

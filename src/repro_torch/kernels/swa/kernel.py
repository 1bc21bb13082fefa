"""Sliding-window flash attention on Hopper: launch wrapper of
``repro_torch/csrc/swa.cu`` (which says what bounds it and how it is
built).

One block owns 64 query rows of one (batch, query head) and walks only
the 64-key tiles that meet its band; the (rows, keys) score matrix
never leaves the SM and the softmax is online, in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0     # wrapper calls that launched the kernel, in this process

HEAD_DIMS = (16, 32, 64, 128, 256)     # head_dim values the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def swa_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int, scale: float,
                         softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, Hq, D); k/v (B, S, Hkv, D), Hq a multiple of Hkv; one
    dtype (fp32 or bf16), contiguous, 16-byte aligned, on one CUDA
    device; D in ``HEAD_DIMS``.

    Returns o (B, S, Hq, D) in q's dtype, launched on the current
    stream: causal attention over keys ``qpos - window < kpos <= qpos``,
    scores scaled by ``scale`` and soft-capped when ``softcap > 0``."""
    global launches
    tensors = (q, k, v)
    if q.device.type != "cuda" or any(
            t.device != q.device or not t.is_contiguous()
            or t.data_ptr() % 16 for t in tensors):
        raise ValueError("swa_attention_kernel takes contiguous, 16-byte "
                         "aligned tensors on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("swa_attention_kernel takes fp32 or bf16 q/k/v of "
                        f"one dtype, got {[str(t.dtype) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("swa_attention_kernel shapes: q (B, S, Hq, D), k/v "
                         f"(B, S, Hkv, D); got {[tuple(t.shape) for t in tensors]}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"swa_attention_kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library("swa")
    fn = lib.swa_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(t.data_ptr() for t in (q, k, v, out)), _DTYPES[q.dtype],
             b, s, hq, hkv, d, int(window), float(scale), float(softcap),
             stream)
    _build.check(lib, "swa", err)
    launches += 1
    return out

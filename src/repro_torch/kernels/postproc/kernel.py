"""NVDLA post-processing unit (SDP + PDP) on Hopper: launch wrapper of
the fused pass (``repro_torch/csrc/postproc.cu``, which says what bounds
it and how it is built).

NVDLA streams conv-core output through SDP (bias / per-channel scale /
activation) and PDP (pooling) before it ever returns to DRAM.  The
Hopper kernel fuses the same chain into one pass over the NHWC map:
every input is read once, and only the pooled map is written.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}

launches = 0     # kernel launches in this process


def postprocess_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, out: torch.Tensor, *, act: str,
                       pool: int) -> torch.Tensor:
    """Launch on the current stream.  x (N, H, W, C) fp32 or bf16;
    scale/bias (C,) fp32; out (N, H // pool, W // pool, C) fp32 or bf16;
    all on one CUDA device and contiguous (``ops.postprocess`` checks)."""
    global launches
    n, h, w, c = x.shape
    tensors = (x, scale, bias, out)
    if x.device.type != "cuda" or any(
            t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("postprocess_kernel takes contiguous tensors on "
                         "one CUDA device")
    io = (torch.float32, torch.bfloat16)
    if x.dtype not in io or out.dtype not in io or \
            (scale.dtype, bias.dtype) != (torch.float32, torch.float32):
        raise TypeError("postprocess_kernel takes fp32 or bf16 x and out, "
                        "fp32 scale/bias")
    if pool < 1 or act not in ACTS or scale.shape != (c,) \
            or bias.shape != (c,) or out.shape != (n, h // pool, w // pool, c):
        raise ValueError("postprocess_kernel shapes: x (N, H, W, C), "
                         "scale/bias (C,), out (N, H // pool, W // pool, C)")
    lib = _build.library("postproc")
    fn = lib.postproc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
             bias.data_ptr(), out.data_ptr(),
             int(out.dtype == torch.bfloat16), n, h, w, c, ACTS[act], pool,
             stream)
    _build.check(lib, "postproc", err)
    launches += 1
    return out

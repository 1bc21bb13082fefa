"""NVDLA convolutional core on Hopper: launch wrapper of the int8 GEMM
with the fused SDP epilogue (``repro_torch/csrc/convcore.cu``, which
says what bounds it and how it is built).

NVDLA's conv core is 2048 INT8 MACs fed from a 512 KiB convolutional
buffer; conv and FC layers are lowered to matrix multiplies whose
operand tiles are staged in that buffer.  The Hopper kernel keeps the
insight — stage int8 operand tiles in on-chip (shared) memory, multiply
on the int8 tensor cores, apply SDP's per-channel scale, bias and ReLU
in registers so the output leaves the chip exactly once — with Hopper's
geometry: 128 x 64/128 output tiles, 32-byte K slices.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

K_QUANTUM = 32   # the kernel's K slice: Kp % K_QUANTUM == 0

launches = 0     # kernel launches in this process


def matmul_int8_kernel(a: torch.Tensor, bt: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       out: torch.Tensor, *, relu: bool) -> torch.Tensor:
    """Launch on the current stream: out (M, N) = epilogue(a @ bt.T).

    a (M, Kp) int8, bt (N, Kp) int8 (B transposed), scale/bias (N,)
    fp32, out (M, N) fp32 or bf16; all on one CUDA device, contiguous,
    16-byte aligned, Kp % K_QUANTUM == 0 (``ops.matmul_int8`` pads)."""
    global launches
    m, kp = a.shape
    n = bt.shape[0]
    tensors = (a, bt, scale, bias, out)
    if a.device.type != "cuda" or any(
            t.device != a.device or not t.is_contiguous() for t in tensors):
        raise ValueError("matmul_int8_kernel takes contiguous tensors on "
                         "one CUDA device")
    if (a.dtype, bt.dtype, scale.dtype, bias.dtype) != \
            (torch.int8, torch.int8, torch.float32, torch.float32) or \
            out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("matmul_int8_kernel takes int8 a/bt, fp32 "
                        "scale/bias and an fp32 or bf16 out")
    if bt.shape != (n, kp) or kp % K_QUANTUM or scale.shape != (n,) \
            or bias.shape != (n,) or out.shape != (m, n) \
            or a.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("matmul_int8_kernel shapes: a (M, Kp), bt (N, "
                         f"Kp), Kp % {K_QUANTUM} == 0, scale/bias (N,), "
                         "out (M, N), a and bt 16-byte aligned")
    lib = _build.library("convcore")
    fn = lib.convcore_matmul_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), bt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             out.data_ptr(), m, n, kp, int(relu),
             int(out.dtype == torch.bfloat16), stream)
    _build.check(lib, "convcore", err)
    launches += 1
    return out

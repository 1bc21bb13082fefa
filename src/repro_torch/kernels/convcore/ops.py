"""Public convcore ops: checks, padding plumbing + conv-as-GEMM (im2col).

``conv2d_int8`` is the NVDLA conv-layer pipeline: im2col the int8
activations, run the int8 GEMM with the fused SDP epilogue (bias +
per-channel scale + ReLU), reshape back to NHWC.  Tensors on a CUDA
device go through the Hopper kernel (``kernel.py``) — or raise; CPU
tensors take the plain version (``ref.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.convcore import kernel as K
from repro_torch.kernels.convcore import ref

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's TMA loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def matmul_int8(a: torch.Tensor, b: torch.Tensor,
                scale: torch.Tensor | None = None,
                bias: torch.Tensor | None = None, *, relu: bool = False,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (M, K) @ (K, N) with fused dequant epilogue; any M/N/K."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_int8 needs (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"matmul_int8 takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}")
    m, k = a.shape
    n = b.shape[1]
    dev = a.device
    scale = (torch.ones(n, device=dev) if scale is None
             else scale.to(torch.float32))
    bias = (torch.zeros(n, device=dev) if bias is None
            else bias.to(torch.float32))
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"scale and bias must be ({n},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if any(t.device != dev for t in (b, scale, bias)):
        raise ValueError("matmul_int8 operands must share one device")
    if dev.type == "cpu":
        return ref.matmul_int8_ref(a, b, scale, bias, relu=relu,
                                   out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"matmul_int8 runs on cuda (kernel) or cpu "
                         f"(plain version), not {dev.type}")
    # the copies that stay: K padded where TMA's 16-byte row stride needs
    # it (layer 0's K = 27; nowhere else in a frame), and B transposed,
    # since int8 wgmma reads both operands K-major
    pad = (-k) % K.K_QUANTUM
    a_p = _aligned(F.pad(a, (0, pad)) if pad else a)
    bt = _aligned(F.pad(b.t(), (0, pad)) if pad else b.t())
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    return K.matmul_int8_kernel(a_p, bt, _aligned(scale), _aligned(bias),
                                out, relu=relu)


def im2col(x: torch.Tensor, kh: int, kw: int, *, stride: int = 1,
           padding: int = 0):
    """x (N, H, W, C) -> patches (N*H'*W', KH*KW*C), plus (H', W').

    Patch columns are ordered (KH, KW, C), matching the HWIO weight
    reshape — ``F.unfold``'s (C, KH, KW) order would not."""
    n, h, w, c = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    cols = [x[:, i:i + (ho - 1) * stride + 1:stride,
              j:j + (wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    patches = torch.stack(cols, dim=3)         # (N, H', W', KH*KW, C)
    return patches.reshape(n * ho * wo, kh * kw * c), (ho, wo)


def conv2d_int8(x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor | None = None,
                bias: torch.Tensor | None = None, *, stride: int = 1,
                padding: int = 0, relu: bool = False,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """NVDLA conv layer. x (N,H,W,C) int8; w (KH,KW,C,O) int8."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_int8 needs x (N,H,W,C) and w "
                         f"(KH,KW,C,O), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    n = x.shape[0]
    kh, kw, c, o = w.shape
    patches, (ho, wo) = im2col(x, kh, kw, stride=stride, padding=padding)
    wmat = w.reshape(kh * kw * c, o)
    out = matmul_int8(patches, wmat, scale, bias, relu=relu,
                      out_dtype=out_dtype)
    return out.reshape(n, ho, wo, o)

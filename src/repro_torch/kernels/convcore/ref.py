"""Plain PyTorch version of the convcore int8 GEMM + fused epilogue.

The integer products are summed in float64, which is exact here: every
partial sum is an integer below 127^2 * K < 2^31 << 2^53, whatever the
order.  (PyTorch has no integer matmul on CUDA; float64 serves both
devices with one code path.)  The epilogue then rounds twice in fp32,
``acc * scale + bias``, as the reference does."""
from __future__ import annotations

import torch


def _epilogue(acc: torch.Tensor, scale, bias, relu: bool, out_dtype):
    out = acc.to(torch.float32) * scale + bias
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.to(out_dtype)


def matmul_int8_ref(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, relu: bool = False,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) out_dtype."""
    acc = a.to(torch.float64) @ b.to(torch.float64)
    return _epilogue(acc, scale[None, :], bias[None, :], relu, out_dtype)


def conv2d_int8_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, stride: int = 1, padding: int = 0,
                    relu: bool = False, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """x (N, H, W, C) int8; w (KH, KW, C, O) int8 -> (N, H', W', O).

    A direct convolution: one exact float64 product per filter tap,
    summed over the taps — independent of the im2col lowering that
    ``ops.conv2d_int8`` uses."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    xp = torch.nn.functional.pad(x.to(torch.float64),
                                 (0, 0, padding, padding, padding, padding))
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (wd + 2 * padding - kw) // stride + 1
    w64 = w.to(torch.float64)
    acc = torch.zeros((n, ho, wo, o), dtype=torch.float64, device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + (ho - 1) * stride + 1:stride,
                     j:j + (wo - 1) * stride + 1:stride, :]
            acc += tap @ w64[i, j]
    return _epilogue(acc, scale, bias, relu, out_dtype)

"""INT8 symmetric quantization for the accelerated path.

NVDLA computes conv/FC in int8 with per-channel weight scales (the
"calibration table" the NVDLA compiler produces); the CPU-side layers run
fp32 — the fp<->int conversions at the boundary are exactly the ones the
paper attributes to the processor.  ``torch.round`` rounds half to even,
as the reference's ``jnp.round`` does, so both quantize to the same int8.
"""
from __future__ import annotations

import torch


def calibrate(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric amax calibration -> scale (per-`axis` or scalar)."""
    amax = x.abs().amax() if axis is None else x.abs().amax(dim=axis)
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_conv_weights(w: torch.Tensor):
    """w (KH, KW, Cin, Cout) fp32 -> (int8, per-output-channel scale)."""
    scale = calibrate(w, axis=(0, 1, 2))            # (Cout,)
    return quantize(w, scale[None, None, None, :]), scale

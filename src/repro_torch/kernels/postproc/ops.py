"""Public postproc op: checks around the fused kernel.  Tensors on a
CUDA device go through the Hopper kernel (``kernel.py``) — or raise; CPU
tensors take the plain version (``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.postproc import kernel as K
from repro_torch.kernels.postproc import ref

_DTYPES = (torch.float32, torch.bfloat16)


def postprocess(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                act: str = "relu", pool: int = 1,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused bias+scale+activation (+maxpool). x (N, H, W, C) ->
    (N, H // pool, W // pool, C)."""
    if x.dim() != 4:
        raise ValueError(f"postprocess needs x (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"postprocess takes and gives {_DTYPES}, got "
                        f"{x.dtype} -> {out_dtype}")
    if act not in K.ACTS:
        raise ValueError(f"unknown activation {act!r}; one of "
                         f"{sorted(K.ACTS)}")
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    n, h, w, c = x.shape
    scale = scale.to(torch.float32)
    bias = bias.to(torch.float32)
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale and bias must be ({c},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("postprocess operands must share one device")
    if x.device.type == "cpu":
        return ref.postprocess_ref(x, scale, bias, act=act, pool=pool,
                                   out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"postprocess runs on cuda (kernel) or cpu "
                         f"(plain version), not {x.device.type}")
    out = torch.empty((n, h // pool, w // pool, c), dtype=out_dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    return K.postprocess_kernel(x.contiguous(), scale.contiguous(),
                                bias.contiguous(), out, act=act, pool=pool)

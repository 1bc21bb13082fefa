"""Sliding-window flash attention on Hopper: launch wrappers of
``repro_torch/csrc/swa.cu`` (the forward) and ``csrc/swa_bwd.cu`` (its
backward pass), which say what bounds them and how they are built.

Two kernels, picked here by dtype: bf16 goes to the tensor-core kernel
(``wgmma`` fed by TMA; a block owns 128 query rows of one (batch, query
head) as two 64-row warpgroups sharing each key/value tile), fp32 to
the FMA kernel (fp32 products, which the 2e-5 fp32 tolerance needs).
Both walk only the 64-key tiles that meet a block's band; the score
matrix never leaves the SM and the softmax is online, in fp32.  The
backward (``swa_attention_bwd_kernel``) recomputes the probabilities
from q and k in two grids, dQ by query tile and dK/dV by key tile, on
the FMA units for both dtypes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0     # wrapper calls that launched a kernel, in this process
launches_by_path = {"tc": 0, "fma": 0}   # the same calls, by kernel

HEAD_DIMS = (16, 32, 64, 128, 256)     # head_dim values both kernels are built for
# dtype -> (path, C launch function): "tc" the bf16 wgmma/TMA kernel,
# "fma" the fp32 FMA kernel
PATHS = {torch.bfloat16: ("tc", "swa_tc_launch"),
         torch.float32: ("fma", "swa_fma_launch")}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded library, its launch functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("swa")
        for _, name in PATHS.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
                + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.swa_tc_smem_bytes.restype = ctypes.c_int
        lib.swa_tc_smem_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head dim ``d``."""
    return _library().swa_tc_smem_bytes(d)


def swa_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int, scale: float,
                         softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, Hq, D); k/v (B, S, Hkv, D), Hq a multiple of Hkv; one
    dtype (bf16: tensor cores, fp32: FMA), contiguous, 16-byte aligned,
    on one CUDA device; D in ``HEAD_DIMS``.

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
    if q.dtype not in PATHS or k.dtype != q.dtype or v.dtype != q.dtype:
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
    lib = _library()
    path, name = PATHS[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, name)(*(t.data_ptr() for t in (q, k, v, out)), b, s,
                             hq, hkv, d, int(window), float(scale),
                             float(softcap), stream)
    _build.check(lib, "swa", err)
    launches += 1
    launches_by_path[path] += 1
    return out


# --------------------------------------------------------------------------
# the backward pass: repro_torch/csrc/swa_bwd.cu
# --------------------------------------------------------------------------
bwd_launches = 0   # backward wrapper calls (two grids each), in this process

_bwd_lib: ctypes.CDLL | None = None


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.library("swa_bwd")
        lib.swa_bwd_launch.restype = ctypes.c_int
        lib.swa_bwd_launch.argtypes = [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                            ctypes.c_void_p]
        lib.swa_bwd_smem_bytes.restype = ctypes.c_int
        lib.swa_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        _bwd_lib = lib
    return _bwd_lib


def bwd_smem_bytes(d: int) -> dict[str, int]:
    """Dynamic shared memory of the two backward kernels at head dim
    ``d`` (bytes)."""
    lib = _bwd_library()
    return {"swa_bwd_dq": lib.swa_bwd_smem_bytes(d, 0),
            "swa_bwd_dkdv": lib.swa_bwd_smem_bytes(d, 1)}


def swa_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, window: int, scale: float,
                             softcap: float = 0.0):
    """Gradients of ``swa_attention_kernel``'s output ``o`` given its
    cotangent ``do``: q/o/do (B, S, Hq, D), k/v (B, S, Hkv, D); one
    dtype (bf16 or fp32), contiguous, 16-byte aligned, on one CUDA
    device; D in ``HEAD_DIMS``.

    Returns (dq, dk, dv) in the operands' dtype, launched on the
    current stream: the ``swa_bwd_dq`` grid (which also writes the
    rows' log-sum-exp and ``rowsum(do * o)`` to fp32 scratch), then the
    ``swa_bwd_dkdv`` grid, which sums each KV head's group of query
    heads without atomics."""
    global bwd_launches
    tensors = (q, k, v, o, do)
    if q.device.type != "cuda" or any(
            t.device != q.device or not t.is_contiguous()
            or t.data_ptr() % 16 for t in tensors):
        raise ValueError("swa_attention_bwd_kernel takes contiguous, "
                         "16-byte aligned tensors on one CUDA device")
    if q.dtype not in PATHS or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("swa_attention_bwd_kernel takes fp32 or bf16 "
                        "operands of one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("swa_attention_bwd_kernel shapes: q/o/do (B, S, "
                         "Hq, D), k/v (B, S, Hkv, D); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"swa_attention_bwd_kernel is built for head_dim "
                         f"in {HEAD_DIMS}, got {d}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    lse, delta = (torch.empty((b, hq, s), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.swa_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse, delta)),
        b, s, hq, hkv, d, int(window), float(scale), float(softcap),
        int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, "swa_bwd", err)
    bwd_launches += 1
    return dq, dk, dv

"""Sliding-window flash attention on Hopper: launch wrappers of
``repro_torch/csrc/swa.cu`` (the forward) and ``csrc/swa_bwd.cu`` (its
backward pass), which say what bounds them and how they are built.

Two kernels, picked here by dtype: bf16 goes to the tensor-core kernel
(``wgmma`` fed by TMA; a block owns 128 query rows of one (batch, query
head) as two 64-row warpgroups sharing each key/value tile), fp32 to
the FMA kernel (fp32 products, which the 2e-5 fp32 tolerance needs).
Both walk only the 64-key tiles that meet a block's band; the score
matrix never leaves the SM and the softmax is online, in fp32.  The
bf16 kernel also writes each row's log-sum-exp when asked.

The backward (``swa_attention_bwd_kernel``) recomputes the
probabilities from q and k, with no atomics, by one of two routes that
``bwd_route`` picks by dtype and head dim: bf16 at D <= 128 on the
tensor cores (a dQ grid by query tile, a dK/dV grid by key tile and
query head, and a pass that sums each GQA group's fp32 shares in head
order), from the forward's log-sum-exp; fp32, and bf16 at D 256, on the
FMA units (a dQ grid and a dK/dV grid by key tile and KV head).
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


def lse_buffer(q: torch.Tensor) -> torch.Tensor:
    """The fp32 (B, Hq, S) log-sum-exp the tensor-core forward writes
    with ``with_lse``, on q's device: what the card wrapper allocates
    and the meta route (``ops``) allocates in its place."""
    b, s, hq, _ = q.shape
    return torch.empty((b, hq, s), dtype=torch.float32, device=q.device)


def _library() -> ctypes.CDLL:
    """The loaded library, its launch functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("swa")
        for _, name in PATHS.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            pointers = 5 if name == "swa_tc_launch" else 4   # + lse
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 6 \
                + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.swa_tc_smem_bytes.restype = ctypes.c_int
        lib.swa_tc_smem_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def tc_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the bf16 kernel at head dim ``d``."""
    return _library().swa_tc_smem_bytes(d)


def swa_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int, scale: float, softcap: float = 0.0,
                         with_lse: bool = False):
    """q (B, S, Hq, D); k/v (B, S, Hkv, D), Hq a multiple of Hkv; one
    dtype (bf16: tensor cores, fp32: FMA), contiguous, 16-byte aligned,
    on one CUDA device; D in ``HEAD_DIMS``.

    Returns o (B, S, Hq, D) in q's dtype, launched on the current
    stream: causal attention over keys ``qpos - window < kpos <= qpos``,
    scores scaled by ``scale`` and soft-capped when ``softcap > 0``.
    With ``with_lse`` (bf16 only) returns (o, lse): each row's
    log-sum-exp of its capped, scaled scores, fp32 (B, Hq, S), which the
    tensor-core backward reads."""
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
    path, name = PATHS[q.dtype]
    if with_lse and path != "tc":
        raise TypeError("swa_attention_kernel writes the log-sum-exp on the "
                        "bf16 tensor-core path only")
    out = torch.empty_like(q)
    lse = lse_buffer(q) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = _library()
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    if path == "tc":
        ptrs.append(lse.data_ptr() if with_lse else None)
    with _build.launch_stream(q.device) as stream:
        err = getattr(lib, name)(*ptrs, b, s, hq, hkv, d, int(window),
                                 float(scale), float(softcap), stream)
    _build.check(lib, "swa", err)
    launches += 1
    launches_by_path[path] += 1
    return (out, lse) if with_lse else out


# --------------------------------------------------------------------------
# the backward pass: repro_torch/csrc/swa_bwd.cu
# --------------------------------------------------------------------------
bwd_launches = 0   # backward wrapper calls, in this process
bwd_launches_by_path = {"tc": 0, "fma": 0}   # the same calls, by route
STATS_ROWS = 64    # the tensor-core route's stats scratch pads S to this


def bwd_scratch(q: torch.Tensor) -> dict[str, torch.Tensor]:
    """The fp32 scratch ``swa_attention_bwd_kernel`` allocates for
    operands shaped like q (B, S, Hq, D), by ``bwd_route``: the
    tensor-core route's rows' (lse, delta) padded to ``STATS_ROWS`` and
    each query head's dK/dV share; the FMA route's rows' lse and delta.
    The card wrapper and the meta route (``ops``) both allocate it."""
    b, s, hq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    if bwd_route(q.dtype, d) == "tc":
        sp = -(-s // STATS_ROWS) * STATS_ROWS
        return {"stats": torch.empty((b, hq, sp, 2), **f32),
                "part": torch.empty((2, b, s, hq, d), **f32)}
    return {name: torch.empty((b, hq, s), **f32)
            for name in ("lse_s", "delta")}


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward's route: "tc" (tensor cores, from the forward's
    log-sum-exp) for bf16 at D <= 128; "fma" (the FMA grids, which find
    the log-sum-exp themselves) for fp32, which the 1e-4 fp32 tolerance
    needs, and for bf16 at D 256, whose dK and dV accumulators do not fit
    a warpgroup's registers."""
    return "tc" if dtype == torch.bfloat16 and d <= 128 else "fma"


_bwd_lib: ctypes.CDLL | None = None


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.library("swa_bwd")
        lib.swa_bwd_tc_launch.restype = ctypes.c_int
        lib.swa_bwd_tc_launch.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        lib.swa_bwd_fma_launch.restype = ctypes.c_int
        lib.swa_bwd_fma_launch.argtypes = [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                            ctypes.c_void_p]
        lib.swa_bwd_smem_bytes.restype = ctypes.c_int
        lib.swa_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        _bwd_lib = lib
    return _bwd_lib


def bwd_smem_bytes(d: int) -> dict[str, int]:
    """Dynamic shared memory of the backward kernels at head dim ``d``
    (bytes; -1 where a route is not built for ``d``)."""
    lib = _bwd_library()
    return {"swa_bwd_tc": lib.swa_bwd_smem_bytes(d, 0),
            "swa_bwd_dq": lib.swa_bwd_smem_bytes(d, 1),
            "swa_bwd_dkdv": lib.swa_bwd_smem_bytes(d, 2)}


def swa_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, window: int, scale: float,
                             softcap: float = 0.0,
                             lse: torch.Tensor | None = None):
    """Gradients of ``swa_attention_kernel``'s output ``o`` given its
    cotangent ``do``: q/o/do (B, S, Hq, D), k/v (B, S, Hkv, D); one
    dtype (bf16 or fp32), contiguous, 16-byte aligned, on one CUDA
    device; D in ``HEAD_DIMS``.

    Returns (dq, dk, dv) in the operands' dtype, launched on the
    current stream, by ``bwd_route``'s rule: on the "tc" route ``lse``,
    the forward's fp32 (B, Hq, S) log-sum-exp (``with_lse``), is
    required, and the ``swa_bwd_tc_dq`` grid, the ``swa_bwd_tc_dkdv``
    grid (one block per query head, its fp32 dK/dV share in scratch) and
    ``swa_bwd_reduce`` (each group summed in head order) run; on the
    "fma" route ``lse`` must be None, and the ``swa_bwd_dq`` grid (which
    writes the rows' log-sum-exp and ``rowsum(do * o)`` to fp32 scratch)
    and the ``swa_bwd_dkdv`` grid, which sums each KV head's group of
    query heads, run.  Neither uses atomics."""
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
    route = bwd_route(q.dtype, d)
    if route == "tc" and (lse is None or lse.shape != (b, hq, s)
                          or lse.dtype != torch.float32
                          or lse.device != q.device
                          or not lse.is_contiguous()):
        raise ValueError("the tensor-core backward takes the forward's fp32 "
                         f"(B, Hq, S) = {(b, hq, s)} log-sum-exp as lse")
    if route == "fma" and lse is not None:
        raise ValueError("the FMA backward finds the log-sum-exp itself: "
                         "lse must be None")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    lib = _bwd_library()
    scratch = bwd_scratch(q)
    with _build.launch_stream(q.device) as stream:
        if route == "tc":
            stats, part = scratch["stats"], scratch["part"]
            err = lib.swa_bwd_tc_launch(
                *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                         stats, part)),
                b, s, stats.shape[2], hq, hkv, d, int(window), float(scale),
                float(softcap), stream)
        else:
            err = lib.swa_bwd_fma_launch(
                *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv,
                                         scratch["lse_s"], scratch["delta"])),
                b, s, hq, hkv, d, int(window), float(scale), float(softcap),
                int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, "swa_bwd", err)
    bwd_launches += 1
    bwd_launches_by_path[route] += 1
    return dq, dk, dv

"""Mamba-2 SSD intra-chunk step on Hopper: launch wrappers of
``repro_torch/csrc/ssd.cu`` and of its backward,
``repro_torch/csrc/ssd_bwd.cu`` (which say what bounds them and how
they are built).

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


def fwd_buffers(x: torch.Tensor, B: torch.Tensor):
    """The forward's outputs for x (bb, nc, q, h, p) and B (bb, nc, q,
    n): y_intra like x and the fp32 states (bb, nc, h, n, p), on x's
    device.  The card wrapper and the meta route (``ops``) both
    allocate them."""
    bb, nc, _, h, p = x.shape
    return torch.empty_like(x), torch.empty(
        (bb, nc, h, B.shape[-1], p), dtype=torch.float32, device=x.device)


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
    y, states = fwd_buffers(x, B)
    if y.numel() == 0 or states.numel() == 0:
        return y, states
    lib = _build.library("ssd")
    fn = lib.ssd_intra_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    with _build.launch_stream(x.device) as stream:
        err = fn(*(t.data_ptr() for t in (x, dt, cum, B, C, y, states)),
                 bb * nc, q, h, p, n, stream)
    _build.check(lib, "ssd", err)
    launches += 1
    return y, states


# --------------------------------------------------------------------------
# the backward pass: repro_torch/csrc/ssd_bwd.cu
# --------------------------------------------------------------------------
bwd_launches = 0   # backward wrapper calls that launched the kernels

_BWD_GRIDS = ("ssd_bwd_cb", "ssd_bwd_ds", "ssd_bwd_dx", "ssd_bwd_bc")
BWD_TILE = 64        # the tile edge of every backward grid
BWD_HEAD_GROUP = 8   # heads of a ssd_bwd_ds block (the C side's HG)
BWD_MAX_P = 64       # one 64-wide tile of p: dS's depth, U's and gx's width


def bwd_plan(cells: int, q: int, h: int, p: int, n: int) -> dict:
    """The sizes ``ssd_bwd_launch`` works in: the tiles of q (``tiles``,
    q padded to ``qp``), the 64-column halves of n (``halves``), the head
    groups of ``ssd_bwd_ds`` (``groups``), and the scratch the grids
    need (shapes, fp32)."""
    t = BWD_TILE
    tiles = -(-q // t)
    groups = -(-h // BWD_HEAD_GROUP)
    return {
        "tiles": tiles, "qp": t * tiles, "halves": -(-n // t), "groups": groups,
        "scratch": {"cb": (cells, t * tiles, t * tiles),
                    "gcbp": (cells, groups, t * tiles, t * tiles),
                    "rowp": (cells, tiles, h, q), "colq": (cells, tiles, h, q),
                    "rbuf": (cells, h, q)}}


def bwd_scratch(x: torch.Tensor, B: torch.Tensor) -> list[torch.Tensor]:
    """The fp32 scratch of ``bwd_plan`` for x (bb, nc, q, h, p) and B
    (bb, nc, q, n), on x's device.  The card wrapper and the meta route
    (``ops``) both allocate it."""
    bb, nc, q, h, p = x.shape
    plan = bwd_plan(bb * nc, q, h, p, B.shape[-1])
    return [torch.empty(shape, dtype=torch.float32, device=x.device)
            for shape in plan["scratch"].values()]


def bwd_issued_flops(q: int, h: int, p: int, n: int) -> int:
    """FLOPs the backward's products issue for one cell, counted as the
    bound counts them (2 M N K, one pass of the three): whole 64 x 64
    tiles, p and every 64-wide k stage padded to 64."""
    plan = bwd_plan(1, q, h, p, n)
    tiles, halves = plan["tiles"], plan["halves"]
    pairs = tiles * (tiles + 1) // 2
    stage = 2 * BWD_TILE ** 3          # one 64 x 64 x 64 product
    stages = (pairs * halves              # cb: C.B^T over n
              + pairs * h                 # ds: dS = gy x^T
              + h * (tiles * halves + pairs)  # dx: U = B gst, S^T gy
              + 2 * pairs * halves        # bc: gC, gB's gCB^T C
              + tiles * halves * h)       # bc: gB's state term
    return stages * stage


def _bwd_library() -> ctypes.CDLL:
    lib = _build.library("ssd_bwd")
    lib.ssd_bwd_launch.restype = ctypes.c_int
    lib.ssd_bwd_launch.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_int
    lib.ssd_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.ssd_bwd_head_group.restype = ctypes.c_int
    lib.ssd_bwd_head_group.argtypes = [ctypes.c_int]
    return lib


def bwd_smem_bytes() -> dict[str, int]:
    """Dynamic shared memory of the backward's cb, ds, dx and bc grids
    (bytes)."""
    lib = _bwd_library()
    return {name: lib.ssd_bwd_smem_bytes(i) for i, name in enumerate(_BWD_GRIDS)}


def bwd_blocks_per_sm() -> dict[str, int]:
    """Blocks of each tiled backward grid that fit one SM of this card
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = _bwd_library()
    lib.ssd_bwd_blocks_per_sm.restype = ctypes.c_int
    lib.ssd_bwd_blocks_per_sm.argtypes = [ctypes.c_int]
    return {name: lib.ssd_bwd_blocks_per_sm(i) for i, name in enumerate(_BWD_GRIDS)}


def built_head_groups() -> tuple[int, int]:
    """The built library's heads per ``ssd_bwd_ds`` block (must equal
    ``BWD_HEAD_GROUP``, by which the wrapper sizes the scratch) and per
    ``ssd_bwd_dx`` block."""
    lib = _bwd_library()
    return lib.ssd_bwd_head_group(0), lib.ssd_bwd_head_group(1)


def ssd_intra_chunk_bwd_kernel(x: torch.Tensor, dt: torch.Tensor,
                               cum: torch.Tensor, B: torch.Tensor,
                               C: torch.Tensor, gy: torch.Tensor,
                               gst: torch.Tensor):
    """Gradients of ``ssd_intra_chunk_kernel``'s (y_intra, states) given
    their cotangents: x/gy (bb, nc, q, h, p); dt/cum (bb, nc, q, h); B/C
    (bb, nc, q, n); gst (bb, nc, h, n, p) (zeros where the states feed
    nothing); all fp32, contiguous, 16-byte aligned, on one CUDA device;
    p at most 64.

    Returns (gx, gdt, gcum, gB, gC) in the operands' shapes, fp32,
    launched on the current stream: the ``ssd_bwd_cb``, ``ssd_bwd_ds``,
    ``ssd_bwd_dx``, ``ssd_bwd_bc`` and ``ssd_bwd_reduce`` grids, through
    fp32 scratch (``bwd_plan``: C·Bᵀ and gCB's head-group partials per
    cell, the row and column partials and r).  No atomics: two launches
    on the same inputs are bit-equal."""
    global bwd_launches
    tensors = (x, dt, cum, B, C, gy, gst)
    if x.device.type != "cuda" or any(
            t.device != x.device or not t.is_contiguous()
            or t.data_ptr() % 16 for t in tensors):
        raise ValueError("ssd_intra_chunk_bwd_kernel takes contiguous, "
                         "16-byte aligned tensors on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_intra_chunk_bwd_kernel takes fp32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if x.dim() != 5:
        raise ValueError(f"x must be (bb, nc, q, h, p), got {tuple(x.shape)}")
    bb, nc, q, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (bb, nc, q, h) or cum.shape != (bb, nc, q, h) \
            or B.shape != (bb, nc, q, n) or C.shape != (bb, nc, q, n) \
            or gy.shape != x.shape or gst.shape != (bb, nc, h, n, p):
        raise ValueError("ssd_intra_chunk_bwd_kernel shapes: x/gy (bb, nc, "
                         "q, h, p), dt/cum (bb, nc, q, h), B/C (bb, nc, q, "
                         "n), gst (bb, nc, h, n, p); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if p > BWD_MAX_P:
        raise ValueError(f"ssd_intra_chunk_bwd_kernel takes p <= {BWD_MAX_P}"
                         f" (one tile of the head dim), got p = {p}")
    grads = tuple(torch.empty_like(t) for t in (x, dt, cum, B, C))
    if x.numel() == 0 or B.numel() == 0:
        return tuple(g.zero_() for g in grads)
    scratch = bwd_scratch(x, B)
    lib = _bwd_library()
    with _build.launch_stream(x.device) as stream:
        err = lib.ssd_bwd_launch(
            *(t.data_ptr() for t in (*tensors, *grads, *scratch)),
            bb * nc, q, h, p, n, stream)
    _build.check(lib, "ssd_bwd", err)
    bwd_launches += 1
    return grads

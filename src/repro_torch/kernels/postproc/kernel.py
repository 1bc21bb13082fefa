"""NVDLA post-processing unit (SDP + PDP) on Hopper: launch wrapper and
launch plan of the fused pass (``repro_torch/csrc/postproc.cu``, which
says what bounds it and how it is built).

NVDLA streams conv-core output through SDP (bias / per-channel scale /
activation) and PDP (pooling) before it ever returns to DRAM.  The
Hopper kernel fuses the same chain into one pass over the NHWC map:
every input is read once, and only the pooled map is written.  A
persistent grid walks items — the pool input rows of one output row over
a span of W and all C — whose rows arrive by ``cp.async.bulk`` into a
ring of shared-memory stages.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

ACTS = {"none": 0, "relu": 1, "sigmoid": 2, "tanh": 3}

# postproc.cu's constants
BLOCKS_PER_SM = 2
MAX_STAGES = 4
STAGE_TARGET = 16 * 1024    # bytes of a ring stage the plan aims at
SMEM_BUDGET = 110 * 1024    # dynamic shared memory of a block, two an SM
BAR_BYTES = 128             # the stages' mbarriers, ahead of the stages
H100_SMS = 132

launches = 0     # kernel launches in this process


@dataclass(frozen=True)
class Plan:
    """How ``postproc.cu`` covers an (N, H, W, C) map, field for field
    its ``Plan``.  An item is one output row (a band: ``pool`` input
    rows) over ``span`` output columns; a band has ``spans`` items and
    the last runs to the end of the row.  ``bulk``: each of an item's
    rows is one ``cp.async.bulk`` of at most ``run`` bytes into a ring
    of ``stages`` stages of ``stage`` bytes (else every block reads its
    items straight from global memory); ``vec``: channels a consumer
    access covers; ``grid`` persistent blocks take every ``grid``-th
    item; ``smem`` bytes of dynamic shared memory a block."""
    bulk: bool
    vec: int
    span: int
    spans: int
    items: int
    run: int
    stage: int
    stages: int
    grid: int
    smem: int


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def launch_plan(n: int, h: int, w: int, c: int, pool: int, in_bytes: int,
                sms: int = H100_SMS) -> Plan:
    """The launch plan of an (n, h, w, c) map of ``in_bytes``-byte
    elements pooled by ``pool`` on ``sms`` SMs.

    A span's row bytes are a multiple of 16 (so every run of a 16-byte
    aligned map whose rows are multiples of 16 bytes starts aligned) and
    fill about ``STAGE_TARGET`` bytes a stage; the spans of a band are
    then evened out.  Rows that are not a multiple of 16 bytes, or items
    whose two stages do not fit the budget, take the direct path; channels
    that are not a multiple of 16 bytes' worth take scalar accesses."""
    ho, wo = h // pool, w // pool
    if n * ho * wo * c == 0:
        return Plan(False, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    px = c * in_bytes                    # bytes of a pixel
    col = pool * px                      # bytes of an output column in a row
    g = 16 // math.gcd(16, col)
    per = max(1, STAGE_TARGET // (pool * col))
    span = max(g, per // g * g)
    spans = -(-wo // span)
    span = _up(-(-wo // spans), g)
    spans = -(-wo // span)
    last = w - (spans - 1) * span * pool
    run = max(last, span * pool if spans > 1 else 0) * px
    stage = _up(pool * run, 128)
    bulk = (w * px) % 16 == 0 and BAR_BYTES + 2 * stage <= SMEM_BUDGET
    items = n * ho * spans
    stages = min(MAX_STAGES, (SMEM_BUDGET - BAR_BYTES) // stage) if bulk \
        else 0
    return Plan(bulk=bulk, vec=16 // in_bytes if bulk and px % 16 == 0 else 1,
                span=span, spans=spans, items=items, run=run, stage=stage,
                stages=stages, grid=min(items, BLOCKS_PER_SM * sms),
                smem=BAR_BYTES + stages * stage if bulk else 0)


def item_extent(plan: Plan, w: int, pool: int, i: int):
    """Item ``i`` of a plan for a map of width ``w``: (band, first output
    column, output columns, first input column, input columns), as
    ``postproc.cu``'s ``item_at``."""
    band, j = divmod(i, plan.spans)
    ow0 = j * plan.span
    col0 = ow0 * pool
    cols = w - col0 if j == plan.spans - 1 else plan.span * pool
    return band, ow0, min(plan.span, w // pool - ow0), col0, cols


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded library, its functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("postproc")
        lib.postproc_launch.restype = ctypes.c_int
        lib.postproc_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.postproc_plan.restype = None
        lib.postproc_plan.argtypes = [ctypes.c_int] * 7 \
            + [ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def built_plan(n: int, h: int, w: int, c: int, pool: int, in_bytes: int,
               sms: int = H100_SMS) -> Plan:
    """The plan the built kernel takes (``postproc.cu``'s own
    ``make_plan``), to hold ``launch_plan`` to it."""
    fields = (ctypes.c_int * 10)()
    _library().postproc_plan(n, h, w, c, pool, in_bytes, sms, fields)
    return Plan(bool(fields[0]), *fields[1:])


def postprocess_kernel(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, out: torch.Tensor, *, act: str,
                       pool: int) -> torch.Tensor:
    """Launch on the current stream.  x (N, H, W, C) fp32 or bf16;
    scale/bias (C,) fp32; out (N, H // pool, W // pool, C) fp32 or bf16;
    all on one CUDA device and contiguous, x and out 16-byte aligned
    (``ops.postprocess`` makes them so)."""
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
            or bias.shape != (c,) or out.shape != (n, h // pool, w // pool, c) \
            or x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("postprocess_kernel shapes: x (N, H, W, C), "
                         "scale/bias (C,), out (N, H // pool, W // pool, C), "
                         "x and out 16-byte aligned")
    lib = _library()
    with _build.launch_stream(x.device) as stream:
        err = lib.postproc_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.bfloat16), n, h, w, c, ACTS[act], pool,
            stream)
    _build.check(lib, "postproc", err)
    launches += 1
    return out

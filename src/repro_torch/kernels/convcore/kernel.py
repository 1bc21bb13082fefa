"""NVDLA convolutional core on Hopper: launch wrapper and launch plan of
the int8 GEMM with the fused SDP epilogue (``repro_torch/csrc/convcore.cu``,
which says what bounds it and how it is built).

NVDLA's conv core is 2048 INT8 MACs fed from a 512 KiB convolutional
buffer; conv and FC layers are lowered to matrix multiplies whose
operand tiles are staged in that buffer.  The Hopper kernel keeps the
insight — stage int8 operand tiles in on-chip (shared) memory, multiply
on the int8 tensor cores, apply SDP's per-channel scale, bias and ReLU
in registers so the output leaves the chip exactly once — with Hopper's
means: TMA loads of 128-byte K slices into a 4-stage ring, ``wgmma`` on
128 x 64/128 output tiles, and a launch plan that fills the card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

K_QUANTUM = 16   # TMA: a row of a or bt is a multiple of 16 bytes
BM = 128         # output rows of a tile
BK = 128         # K bytes of a pipeline stage
MIN_KPS = 4      # fewest K stages a split-K range runs (so its ring fills)
H100_SMS = 132

launches = 0     # kernel launches in this process


@dataclass(frozen=True)
class Plan:
    """How ``convcore.cu`` covers an (M, K) @ (K, N) product: K padded to
    ``kp``; tiles of 128 rows x ``bn`` columns; K's ``ceil(kp / 128)``
    slices cut into ``splits`` ranges of ``kps`` (the last may be
    shorter, none empty); ``m_blocks`` blocks along M, each walking
    every ``m_blocks``-th row tile."""
    kp: int
    bn: int
    splits: int
    kps: int
    m_blocks: int

    @property
    def k_slices(self) -> int:
        return -(-self.kp // BK)

    def k_ranges(self) -> list[tuple[int, int]]:
        """The [start, stop) slice range of each split, in order."""
        return [(z * self.kps, min((z + 1) * self.kps, self.k_slices))
                for z in range(self.splits)]


def launch_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> Plan:
    """The launch plan of an (m, k) @ (k, n) product on ``sms`` SMs.

    K is padded only where TMA needs it (a global row stride is a
    multiple of 16 bytes).  Tiles are 128 columns wide where that gives at
    least half a wave, else 64.  A layer with fewer tiles than SMs splits
    K into as many ranges as fit the card, each at least ``MIN_KPS``
    stages long.  The rest of the card goes to blocks along M."""
    kp = k + (-k) % K_QUANTUM
    m_tiles = -(-m // BM)
    bn = 128 if n > 64 and m_tiles * -(-n // 128) >= sms // 2 else 64
    tiles = m_tiles * -(-n // bn)
    nk = -(-kp // BK)
    splits = max(1, min(sms // tiles, nk // MIN_KPS))
    kps = -(-nk // splits)
    splits = -(-nk // kps)
    m_blocks = min(m_tiles, max(1, sms // (-(-n // bn) * splits)))
    return Plan(kp, bn, splits, kps, m_blocks)


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded library, its functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("convcore")
        fn = lib.convcore_matmul_int8
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        lib.convcore_smem_bytes.restype = ctypes.c_int
        lib.convcore_smem_bytes.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def smem_bytes(bn: int) -> int:
    """Dynamic shared memory of the GEMM kernel at tile width ``bn``."""
    return _library().convcore_smem_bytes(bn)


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
    plan = launch_plan(m, n, kp, torch.cuda.get_device_properties(
        a.device).multi_processor_count)
    partial = torch.empty((plan.splits, m, n), dtype=torch.int32,
                          device=a.device) if plan.splits > 1 else None
    lib = _library()
    with _build.launch_stream(a.device) as stream:
        err = lib.convcore_matmul_int8(
            a.data_ptr(), bt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            m, n, kp, int(relu), int(out.dtype == torch.bfloat16), plan.bn,
            plan.splits, plan.kps, plan.m_blocks, stream)
    _build.check(lib, "convcore", err)
    launches += 1
    return out

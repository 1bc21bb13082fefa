"""The NoC switch's cycle loop on Hopper: the launch wrapper of
``repro_torch/csrc/noc.cu`` (which says what bounds it and how it is
built).

``switch_kernel`` runs one simulation's whole token-bundle loop in one
launch, one warp and a lane a port (behind ``core.noc.NoCSwitch``),
where the plain loop (``ref.py``) launches about forty small ops a
target cycle and reads the delivered count back once a bundle.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_PORTS = 32                   # noc.cu's kMaxPorts: a lane a port
SHARED_FIFO_BYTES = 200 * 1024   # noc.cu's: the largest rings kept on chip
INT32_MAX = 2**31 - 1

launches = 0    # switch_kernel calls that launched, this process

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded library, its functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("noc")
        lib.noc_switch_launch.restype = ctypes.c_int
        lib.noc_switch_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6
        for name in ("noc_max_ports", "noc_shared_fifo_bytes"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        _lib = lib
    return _lib


def built_max_ports() -> int:
    """The most ports the built library takes."""
    return _library().noc_max_ports()


def built_shared_fifo_bytes() -> int:
    """The largest FIFO rings (bytes) the built library keeps in shared
    memory."""
    return _library().noc_shared_fifo_bytes()


def fifo_in_shared(ports: int, depth: int) -> bool:
    """Whether the (ports, depth) rings of (inject, destination) int32
    pairs fit the kernel's shared memory."""
    return 8 * ports * depth <= SHARED_FIFO_BYTES


def switch_kernel(dests: torch.Tensor, status: torch.Tensor,
                  granted: torch.Tensor, src: torch.Tensor, lat: torch.Tensor,
                  fifo: torch.Tensor | None, *, link: int, depth: int,
                  total: int, bundle: int, n_chunks: int) -> None:
    """Launch on the current stream.  dests (T, ports) int32, an entry
    the egress of the flit its port injects that cycle or -1; status (3,)
    int32, written (delivered, overflow, bundles started); granted
    (h_pad, ports) bool, src / lat (h_pad, ports) int32, zero on entry,
    written at every executed cycle; fifo a (ports, depth, 2) int32
    scratch where the rings do not fit shared memory (``fifo_in_shared``),
    else None."""
    global launches
    tensors = dict(dests=dests, status=status, granted=granted, src=src,
                   lat=lat)
    dtypes = dict(dests=torch.int32, status=torch.int32, granted=torch.bool,
                  src=torch.int32, lat=torch.int32, fifo=torch.int32)
    if fifo is not None:
        tensors["fifo"] = fifo
    dev = dests.device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"switch_kernel takes contiguous tensors on one "
                             f"CUDA device ({name}: {t.device}, contiguous "
                             f"{t.is_contiguous()})")
        if t.dtype != dtypes[name]:
            raise TypeError(f"switch_kernel: {name} must be {dtypes[name]}, "
                            f"got {t.dtype}")
    t_rows, ports = dests.shape
    h_pad = granted.shape[0]
    if not 1 <= ports <= MAX_PORTS:
        raise ValueError(f"switch_kernel takes 1..{MAX_PORTS} ports (a lane "
                         f"a port), got {ports}")
    if granted.shape != (h_pad, ports) or src.shape != granted.shape \
            or lat.shape != granted.shape or status.shape != (3,) or (
                fifo is not None and fifo.shape != (ports, depth, 2)):
        raise ValueError("switch_kernel shapes: dests (T, ports), granted / "
                         "src / lat (h_pad, ports), status (3,), fifo "
                         "(ports, depth, 2)")
    if not 1 <= h_pad <= INT32_MAX or not 1 <= depth <= INT32_MAX \
            or not 0 <= link <= INT32_MAX or not 0 <= total <= INT32_MAX \
            or not 1 <= n_chunks <= INT32_MAX or bundle < 1 \
            or t_rows > h_pad:
        raise ValueError(f"switch_kernel takes cycles, depths and counts "
                         f"below 2**31 and a schedule within the horizon; got "
                         f"h_pad {h_pad}, depth {depth}, link {link}, total "
                         f"{total}, {n_chunks} bundles of {bundle}, {t_rows} "
                         "rows")
    if fifo is None and not fifo_in_shared(ports, depth):
        raise ValueError(f"{ports} rings of depth {depth} do not fit "
                         f"{SHARED_FIFO_BYTES} bytes of shared memory: pass "
                         "a fifo scratch")
    lib = _library()
    err = lib.noc_switch_launch(
        dests.data_ptr(), t_rows, ports, link, depth, total, h_pad, bundle,
        n_chunks, None if fifo is None else fifo.data_ptr(),
        status.data_ptr(), granted.data_ptr(), src.data_ptr(),
        lat.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "noc", err)
    launches += 1

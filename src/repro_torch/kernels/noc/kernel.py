"""The NoC switch's cycle loop on Hopper: the launch wrapper of
``repro_torch/csrc/noc.cu`` (which says what bounds it and how it is
built).

``switch_kernel`` runs one simulation's whole token-bundle loop in one
launch (behind ``core.noc.NoCSwitch``), where the plain loop
(``ref.py``) launches about forty small ops a target cycle and reads the
delivered count back once a bundle: up to ``WARP_PORTS`` ports one warp
and a lane a port, more one block of up to ``WIDE_THREADS`` threads, a
thread a port (several past ``WIDE_THREADS``), its port table
(``table_bytes``) and rings in shared memory where they fit, else in
global scratches.  Any port count runs: the limits left are the card's
memory (``ops`` checks it) and int32 indexing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

WARP_PORTS = 32                  # noc.cu's kMaxPorts: the one-warp route
WIDE_THREADS = 1024              # noc.cu's kWideThreads: block route threads
STAGE_CYCLES = 64                # noc.cu's: schedule rows staged at once
STAGE_INTS = 4096                # noc.cu's: the block route's staged entries
PORT_FIELDS = 7                  # noc.cu's kPortFields: port table arrays
SHARED_FIFO_BYTES = 200 * 1024   # noc.cu's: the most shared memory taken
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
            ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 7
        lib.noc_table_bytes.restype = ctypes.c_longlong
        lib.noc_table_bytes.argtypes = [ctypes.c_int]
        for name in ("noc_warp_ports", "noc_wide_threads", "noc_stage_ints",
                     "noc_shared_fifo_bytes"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        _lib = lib
    return _lib


def built_bounds() -> tuple[int, int, int, int]:
    """The built library's (WARP_PORTS, WIDE_THREADS, STAGE_INTS,
    SHARED_FIFO_BYTES)."""
    lib = _library()
    return (lib.noc_warp_ports(), lib.noc_wide_threads(),
            lib.noc_stage_ints(), lib.noc_shared_fifo_bytes())


def built_table_bytes(ports: int) -> int:
    """``table_bytes`` as the built library computes it."""
    return _library().noc_table_bytes(ports)


def threads(ports: int) -> int:
    """Threads of the launch: a warp up to ``WARP_PORTS`` ports, else a
    warp a 32 ports up to ``WIDE_THREADS``."""
    return min(WIDE_THREADS, 32 * -(-ports // 32))


def stage_rows(ports: int) -> int:
    """Schedule rows the block route stages at once: ``STAGE_CYCLES``,
    fewer for wide switches (``STAGE_INTS`` entries), at least one."""
    return max(1, min(STAGE_CYCLES, STAGE_INTS // ports))


def table_bytes(ports: int) -> int:
    """The block route's port table: ``PORT_FIELDS`` int32 arrays of
    ``ports`` and the staged schedule, 16-byte aligned."""
    return -(-4 * ports * (PORT_FIELDS + stage_rows(ports)) // 16) * 16


def table_in_shared(ports: int) -> bool:
    """Whether the block route keeps its port table in shared memory
    (always, up to ``WARP_PORTS`` ports: the one-warp route has none)."""
    return ports <= WARP_PORTS or table_bytes(ports) <= SHARED_FIFO_BYTES


def fifo_in_shared(ports: int, depth: int) -> bool:
    """Whether the (ports, depth) rings of (inject, destination) int32
    pairs fit the kernel's shared memory (beside the block route's port
    table, where that is in shared memory too)."""
    rings = 8 * ports * depth
    if ports <= WARP_PORTS:
        return rings <= SHARED_FIFO_BYTES
    return table_in_shared(ports) \
        and table_bytes(ports) + rings <= SHARED_FIFO_BYTES


def switch_kernel(dests: torch.Tensor, status: torch.Tensor,
                  granted: torch.Tensor, src: torch.Tensor, lat: torch.Tensor,
                  fifo: torch.Tensor | None, table: torch.Tensor | None, *,
                  link: int, depth: int, total: int, bundle: int,
                  n_chunks: int) -> None:
    """Launch on the current stream.  dests (T, ports) int32, an entry
    the egress of the flit its port injects that cycle or -1; status (3,)
    int32, written (delivered, overflow, bundles started); granted
    (h_pad, ports) bool, src / lat (h_pad, ports) int32, zero on entry,
    written at every executed cycle; fifo a (ports, depth, 2) int32
    scratch where the rings do not fit shared memory (``fifo_in_shared``),
    else None; table a (table_bytes(ports) // 4,) int32 scratch where the
    block route's port table does not (``table_in_shared``), else
    None."""
    global launches
    tensors = dict(dests=dests, status=status, granted=granted, src=src,
                   lat=lat)
    dtypes = dict(dests=torch.int32, status=torch.int32, granted=torch.bool,
                  src=torch.int32, lat=torch.int32, fifo=torch.int32,
                  table=torch.int32)
    if fifo is not None:
        tensors["fifo"] = fifo
    if table is not None:
        tensors["table"] = table
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
    if not 1 <= ports <= INT32_MAX:
        raise ValueError(f"switch_kernel takes 1 to 2**31 - 1 ports (int32 "
                         f"indexing), got {ports}")
    if granted.shape != (h_pad, ports) or src.shape != granted.shape \
            or lat.shape != granted.shape or status.shape != (3,) or (
                fifo is not None and fifo.shape != (ports, depth, 2)) or (
                table is not None
                and table.shape != (table_bytes(ports) // 4,)):
        raise ValueError("switch_kernel shapes: dests (T, ports), granted / "
                         "src / lat (h_pad, ports), status (3,), fifo "
                         "(ports, depth, 2), table (table_bytes(ports) // "
                         "4,)")
    if not 1 <= h_pad <= INT32_MAX or not 1 <= depth <= INT32_MAX \
            or not 0 <= link <= INT32_MAX or not 0 <= total <= INT32_MAX \
            or not 1 <= n_chunks <= INT32_MAX or bundle < 1 \
            or t_rows > h_pad:
        raise ValueError(f"switch_kernel takes cycles, depths and counts "
                         f"below 2**31 and a schedule within the horizon; got "
                         f"h_pad {h_pad}, depth {depth}, link {link}, total "
                         f"{total}, {n_chunks} bundles of {bundle}, {t_rows} "
                         "rows")
    if (table is None) != table_in_shared(ports) or (
            fifo is None and not fifo_in_shared(ports, depth)):
        raise ValueError(f"{ports} ports' table and rings of depth {depth}: "
                         f"pass a table scratch exactly where "
                         f"table_in_shared is false and a fifo scratch "
                         f"where fifo_in_shared is ({SHARED_FIFO_BYTES} "
                         "bytes of shared memory)")
    lib = _library()
    with _build.launch_stream(dev) as stream:
        err = lib.noc_switch_launch(
            dests.data_ptr(), t_rows, ports, link, depth, total, h_pad,
            bundle, n_chunks, None if fifo is None else fifo.data_ptr(),
            None if table is None else table.data_ptr(), status.data_ptr(),
            granted.data_ptr(), src.data_ptr(), lat.data_ptr(), stream)
    _build.check(lib, "noc", err)
    launches += 1

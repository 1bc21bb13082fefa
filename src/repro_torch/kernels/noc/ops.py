"""Public NoC switch op.  Tensors on a CUDA device go through the Hopper
kernel (``kernel.py``) at any port count — or raise, past the card's
memory or int32 indexing; CPU tensors take the plain version
(``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.noc import kernel as K
from repro_torch.kernels.noc import ref
from repro_torch.kernels.noc.ref import SwitchRun
from repro_torch.utils.env import check_device_memory


def _device_type(x: torch.Tensor) -> str:
    return x.device.type


def n_bundles(h_pad: int, bundle: int) -> int:
    """``fame1.chunked_scan``'s bundle count for ``h_pad`` cycles: the
    bundles that cover them, rounded up to a power of two."""
    n = max(1, -(-h_pad // bundle))
    return 1 << (n - 1).bit_length()


def _carve(buf: torch.Tensor, spans: list) -> list:
    """Views of ``buf`` (uint8) at ``spans``' (offset, shape, dtype)."""
    return [buf[off:off + torch.Size(shape).numel() * dt.itemsize]
            .view(dt).view(shape) for off, shape, dt in spans]


def switch(dests: torch.Tensor, *, link: int, depth: int, total: int,
           h_pad: int, bundle: int) -> SwitchRun:
    """The switch over the injection schedule ``dests`` (T, ports) int32
    (an entry the egress of the flit its port injects that cycle, or
    -1), ingress FIFOs of ``depth``, ``link`` cycles of input link, for
    ``h_pad`` cycles in bundles of ``bundle``, leaving at the first
    bundle boundary after ``total`` flits delivered
    (``ref.switch_ref`` says what it computes).  The log comes back as
    CPU tensors, from the card in one copy."""
    ports = dests.shape[1]
    if dests.numel() and int(dests.max()) >= ports:
        raise ValueError(f"dests entries must be < ports ({ports}), or -1 "
                         "for no flit")
    dev = _device_type(dests)
    if dev == "cpu":
        return ref.switch_ref(dests, link=link, depth=depth, total=total,
                              h_pad=h_pad, bundle=bundle)
    if dev != "cuda":
        raise ValueError(f"switch runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev}")
    if h_pad > K.INT32_MAX or ports > K.INT32_MAX:
        raise ValueError(f"the switch kernel indexes in int32: h_pad {h_pad} "
                         f"and {ports} ports must be below 2**31")
    # the status and the log in one zeroed buffer: one copy brings them back
    spans, off = [], 0
    for shape, dt in (((3,), torch.int32), ((h_pad, ports), torch.int32),
                      ((h_pad, ports), torch.int32),
                      ((h_pad, ports), torch.bool)):
        spans.append((off, shape, dt))
        off += -(-torch.Size(shape).numel() * dt.itemsize // 8) * 8
    # the rings and the port table in global scratches where shared
    # memory does not hold them
    ring_bytes = 0 if K.fifo_in_shared(ports, depth) else 8 * ports * depth
    table_bytes = 0 if K.table_in_shared(ports) else K.table_bytes(ports)
    check_device_memory(dests.device, off + ring_bytes + table_bytes,
                        f"the switch's log ({h_pad} cycles x {ports} "
                        f"ports), rings ({ports} x depth {depth}) and port "
                        "table")
    buf = torch.zeros(off, dtype=torch.uint8, device=dests.device)
    status, src, lat, granted = _carve(buf, spans)
    fifo = torch.empty((ports, depth, 2), dtype=torch.int32,
                       device=dests.device) if ring_bytes else None
    table = torch.empty(table_bytes // 4, dtype=torch.int32,
                        device=dests.device) if table_bytes else None
    K.switch_kernel(dests.to(torch.int32).contiguous(), status, granted, src,
                    lat, fifo, table, link=link, depth=depth, total=total,
                    bundle=bundle, n_chunks=n_bundles(h_pad, bundle))
    status, src, lat, granted = _carve(buf.cpu(), spans)
    delivered, overflow, bundles = status.tolist()
    return SwitchRun(granted, src, lat, delivered, bool(overflow), bundles)

"""The plain PyTorch version of the NoC switch's cycle loop: the switch's
target-cycle step run through ``core.fame1.chunked_scan``, one eager op
at a time from the host, on the schedule's own device.  The kernel
(``kernel.py``) computes the same log bit for bit;
``tests/test_torch_noc_kernel.py`` holds a numpy emulation of the
kernel's per-cycle warp walk to it."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fame1 import chunked_scan


class SwitchRun(NamedTuple):
    """One simulation's per-cycle log and end state.  granted (h_pad,
    ports) bool; src (h_pad, ports) int32, the granted ingress or -1;
    lat (h_pad, ports) int32, the granted flit's latency or 0; rows past
    the last executed cycle are zero."""
    granted: torch.Tensor
    src: torch.Tensor
    lat: torch.Tensor
    delivered: int
    overflow: bool
    bundles: int


def _switch_cycle(ports: int, link: int, depth: int, device):
    """The switch's target-cycle step for ``chunked_scan``: carry is
    (ts_buf, dst_buf, head, size, rr, delivered, target, ovf) — the
    ingress FIFOs as (ports, depth) ring buffers of inject cycles and
    destinations — and a cycle with ``active`` False changes nothing."""
    p_idx = torch.arange(ports, device=device)

    def cycle(carry, x, active):
        ts_buf, dst_buf, head, size, rr, delivered, target, ovf = carry
        dst_row, cyc = x
        # inject: append this cycle's flits to the ingress FIFOs
        has = active & (dst_row >= 0)
        can = has & (size < depth)
        pos = (head + size) % depth
        ts_buf = ts_buf.index_put(
            (p_idx, pos), torch.where(can, cyc, ts_buf[p_idx, pos]))
        dst_buf = dst_buf.index_put(
            (p_idx, pos), torch.where(can, dst_row, dst_buf[p_idx, pos]))
        ovf = ovf | (has & ~can).any()
        size = size + can.to(size.dtype)
        # arbitrate: cycle-start heads, round-robin per egress
        h_ts = ts_buf[p_idx, head]
        h_dst = dst_buf[p_idx, head]
        elig = active & (size > 0) & (h_ts + link <= cyc)
        cand = elig[None, :] & (h_dst[None, :] == p_idx[:, None])
        # rotation key of ingress p for egress e: (p - rr[e]) mod ports
        key = torch.where(cand, (p_idx[None, :] - rr[:, None]) % ports, ports)
        kmin, sel = key.min(dim=1)
        granted = kmin < ports
        # deliver: pop winners (an ingress head targets exactly one
        # egress, so grants never collide on a port)
        pop = (granted[:, None] & (p_idx[None, :] == sel[:, None])).any(0)
        lat = torch.where(granted, cyc - h_ts[sel], 0)
        src = torch.where(granted, sel, -1)
        head = (head + pop.to(head.dtype)) % depth
        size = size - pop.to(size.dtype)
        rr = torch.where(granted, (sel + 1) % ports, rr)
        delivered = delivered + granted.sum()
        carry = (ts_buf, dst_buf, head, size, rr, delivered, target, ovf)
        return carry, (granted, src, lat)

    return cycle


def switch_ref(dests, *, link: int, depth: int, total: int, h_pad: int,
               bundle: int):
    """The switch over ``dests`` (T, ports), padded to ``h_pad`` cycles
    (padding rows inject nothing), in ``bundle``-cycle bundles through
    ``chunked_scan``, which leaves at the first bundle boundary after
    ``total`` flits delivered.  Returns ``SwitchRun``: the first
    ``h_pad`` cycles of the log (granted bool, src and lat int32) and the
    delivered count, overflow flag and bundles run."""
    dev = dests.device
    ports = dests.shape[1]
    sched = torch.full((h_pad, ports), -1, dtype=torch.int64, device=dev)
    sched[:dests.shape[0]] = dests
    zeros = torch.zeros(ports, dtype=torch.int64, device=dev)
    init = (torch.zeros((ports, depth), dtype=torch.int64, device=dev),
            torch.full((ports, depth), -1, dtype=torch.int64, device=dev),
            zeros, zeros, zeros,
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.tensor(total, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    carry, (granted, src, lat), bundles = chunked_scan(
        _switch_cycle(ports, link, depth, dev), init,
        (sched, torch.arange(h_pad, device=dev)),
        cont_fn=lambda c: c[5] < c[6], chunk_len=bundle)
    return SwitchRun(granted[:h_pad], src[:h_pad].to(torch.int32),
                     lat[:h_pad].to(torch.int32), int(carry[5]),
                     bool(carry[7]), int(bundles))

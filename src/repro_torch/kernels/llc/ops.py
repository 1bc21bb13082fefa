"""Public LLC replay ops.  Tensors on a CUDA device go through the
Hopper kernels (``kernel.py``) at any way count — or raise, past the
card's memory or int32 indexing; CPU tensors take the plain versions
(``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.llc import kernel as K
from repro_torch.kernels.llc import ref
from repro_torch.utils.env import check_device_memory


def _device_type(x: torch.Tensor) -> str:
    return x.device.type


def _route(x: torch.Tensor, what: str) -> str:
    dev = _device_type(x)
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev}")
    return dev


def set_walk(tags: torch.Tensor, age: torch.Tensor, tag_s: torch.Tensor,
             acc_s: torch.Tensor, per_set: torch.Tensor,
             first: torch.Tensor):
    """One geometry's per-set LRU walk over set-ranked arrivals
    (``ref.set_walk_ref`` says what it computes).  Returns (hits (n,)
    bool, tags, age) as new tensors; the inputs are not written."""
    if _route(tag_s, "set_walk") == "cpu":
        return ref.set_walk_ref(tags, age, tag_s, acc_s, per_set, first)
    check_device_memory(tag_s.device, 8 * tags.numel() + tag_s.numel(),
                        f"set_walk's state ({tuple(tags.shape)} sets x "
                        "ways, int32 tags and ages) and hit bits")
    tags = tags.to(torch.int32).clone(memory_format=torch.contiguous_format)
    age = age.to(torch.int32).clone(memory_format=torch.contiguous_format)
    hit = torch.zeros(tag_s.shape, dtype=torch.bool, device=tag_s.device)
    K.set_walk_kernel(tags, age, tag_s.contiguous(), acc_s.contiguous(),
                      per_set.contiguous(), first.contiguous(), hit)
    return hit, tags, age


def _carve(buf: torch.Tensor, spans: list) -> list:
    """Views of ``buf`` (uint8) at ``spans``' (offset, shape, dtype)."""
    return [None if shape is None else
            buf[off:off + torch.Size(shape).numel() * dt.itemsize]
            .view(dt).view(shape) for off, shape, dt in spans]


def lane_scan_many(buckets: list[tuple], *, collect: bool = False,
                   host: bool = False, depths: list[int] | None = None
                   ) -> list[tuple]:
    """Several lane batches' segment replays from their host plans, one
    launch for all of them on the card (two when batches of up to
    ``kernel.THREAD_WAYS`` ways and wider ones meet).  ``buckets``: per
    batch (table, rounds, geo, max_sets, max_ways, r_pad, suffix), each
    what ``lane_scan`` takes.  Returns per batch what ``lane_scan`` returns;
    with ``host`` the outputs come to the host in one copy (CPU
    tensors).  ``depths`` (each batch's total rounds, known to the host
    plan) orders the kernel's blocks, the deepest first; without it the
    rounds are read back.  Each batch's result is its own
    ``lane_scan``'s, bit for bit: batches share nothing but the
    launch."""
    if _route(buckets[0][0], "lane_scan") == "cpu":
        return [ref.lane_scan_ref(table, rounds, geo, max_sets=max_sets,
                                  max_ways=max_ways, r_pad=r_pad,
                                  collect=collect, suffix=suffix)
                for table, rounds, geo, max_sets, max_ways, r_pad, suffix
                in buckets]
    dev = buckets[0][0].device
    plans, spans, off = [], [], 0

    def span(shape, dtype):
        nonlocal off
        at = off
        off += -(-torch.Size(shape).numel() * dtype.itemsize // 8) * 8
        return at, shape, dtype

    for table, rounds, geo, max_sets, max_ways, r_pad, suffix in buckets:
        table, rounds, geo = (t.contiguous() for t in (table, rounds, geo))
        sizes = K.bucket_sizes(table, rounds, geo, max_sets=max_sets,
                               max_ways=max_ways, r_pad=r_pad, suffix=suffix)
        plans.append((table, rounds, geo, sizes))
        lanes, n_seg = sizes["lanes"], sizes["n_seg"]
        state = (lanes, max_ways, max_sets)
        spans.append([span((lanes, n_seg), torch.int64),
                      span((lanes, n_seg, r_pad, max_sets), torch.bool)
                      if collect else (0, None, None),
                      span(state, torch.int32), span(state, torch.int32)])
    miss = sum(torch.Size(s[1][1]).numel() for s in spans) if collect else 0
    check_device_memory(dev, off + K.wide_scratch_bytes(
        [p[3] for p in plans]), f"lane_scan's outputs (the miss bits (L, "
        f"S, r_pad, max_sets) {miss:,} bytes of them) and scratch")
    # one zeroed buffer holds every output, so one copy brings them back
    buf = torch.zeros(off, dtype=torch.uint8, device=dev)
    outs = [_carve(buf, s) for s in spans]
    if depths is None:
        depths = [int(rounds.sum()) for _, rounds, *_ in buckets] \
            if len(buckets) > 1 else [0]
    K.lane_scan_kernel(plans, outs, depths)
    if host:
        buf = buf.cpu()
        outs = [_carve(buf, s) for s in spans]
    return [tuple(o) for o in outs]


def lane_scan(table: torch.Tensor, rounds: torch.Tensor, geo: torch.Tensor,
              *, max_sets: int, max_ways: int, r_pad: int,
              collect: bool = False, suffix: str = "full"):
    """L geometries' segment replay from the host plan
    (``ref.lane_scan_ref`` says what it computes).  Returns (round hits
    (L, S) int64, miss bits (L, S, r_pad, max_sets) bool or None, tags,
    ts), the state (L, max_ways, max_sets) int32, from a cold cache."""
    return lane_scan_many([(table, rounds, geo, max_sets, max_ways, r_pad,
                            suffix)], collect=collect)[0]

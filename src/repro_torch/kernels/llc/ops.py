"""Public LLC replay ops.  Tensors on a CUDA device go through the
Hopper kernels (``kernel.py``) — or raise; CPU tensors take the plain
versions (``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.llc import kernel as K
from repro_torch.kernels.llc import ref


def _device_type(x: torch.Tensor) -> str:
    return x.device.type


def _route(x: torch.Tensor, what: str) -> str:
    dev = _device_type(x)
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda (kernel) or cpu (plain "
                         f"version), not {dev}")
    return dev


def _check_ways(ways: int, what: str) -> None:
    if not 1 <= ways <= K.MAX_WAYS:
        raise ValueError(f"{what}'s kernel takes 1..{K.MAX_WAYS} ways, got "
                         f"{ways}; there is no plain fallback on the card")


def set_walk(tags: torch.Tensor, age: torch.Tensor, tag_s: torch.Tensor,
             acc_s: torch.Tensor, per_set: torch.Tensor,
             first: torch.Tensor):
    """One geometry's per-set LRU walk over set-ranked arrivals
    (``ref.set_walk_ref`` says what it computes).  Returns (hits (n,)
    bool, tags, age) as new tensors; the inputs are not written."""
    if _route(tag_s, "set_walk") == "cpu":
        return ref.set_walk_ref(tags, age, tag_s, acc_s, per_set, first)
    _check_ways(tags.shape[1], "set_walk")
    tags = tags.to(torch.int32).clone(memory_format=torch.contiguous_format)
    age = age.to(torch.int32).clone(memory_format=torch.contiguous_format)
    hit = torch.zeros(tag_s.shape, dtype=torch.bool, device=tag_s.device)
    K.set_walk_kernel(tags, age, tag_s.contiguous(), acc_s.contiguous(),
                      per_set.contiguous(), first.contiguous(), hit)
    return hit, tags, age


def lane_scan(table: torch.Tensor, rounds: torch.Tensor, geo: torch.Tensor,
              *, max_sets: int, max_ways: int, r_pad: int,
              collect: bool = False, suffix: str = "full"):
    """L geometries' segment replay from the host plan
    (``ref.lane_scan_ref`` says what it computes).  Returns (round hits
    (L, S) int64, miss bits (L, S, r_pad, max_sets) bool or None, tags,
    ts), the state (L, max_ways, max_sets) int32, from a cold cache."""
    if _route(table, "lane_scan") == "cpu":
        return ref.lane_scan_ref(table, rounds, geo, max_sets=max_sets,
                                 max_ways=max_ways, r_pad=r_pad,
                                 collect=collect, suffix=suffix)
    _check_ways(max_ways, "lane_scan")
    dev = table.device
    n_lane, n_seg = table.shape[:2]
    tags = torch.full((n_lane, max_ways, max_sets), -1, dtype=torch.int32,
                      device=dev)
    ts = torch.zeros_like(tags)
    hits = torch.zeros((n_lane, n_seg), dtype=torch.int64, device=dev)
    miss = (torch.zeros((n_lane, n_seg, r_pad, max_sets), dtype=torch.bool,
                        device=dev) if collect else None)
    K.lane_scan_kernel(table.contiguous(), rounds.contiguous(),
                       geo.contiguous(), tags, ts, hits, miss, r_pad=r_pad,
                       suffix=suffix)
    return hits, miss, tags, ts

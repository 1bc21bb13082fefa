"""The LLC replay engines on Hopper: launch wrappers of
``repro_torch/csrc/llc.cu`` (which says what bounds them and how they
are built).

``set_walk_kernel`` walks one geometry's set-ranked arrivals, one warp
a block and a set a lane (behind ``core.cache.simulate_segments``);
``lane_scan_kernel`` replays every lane bucket of a call in one launch,
one thread a (bucket, lane, set), its blocks mapped by the host-built
``launch_plan`` (behind ``core.cache.segment_lane_scan_many``).  Each
takes the whole replay in one launch, where the plain loops (``ref.py``)
launch about twenty small ops a round from the host.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_WAYS = 128       # llc.cu's kMaxWays: the widest set the kernels take
SCAN_THREADS = 64    # llc.cu's SCAN_THREADS: (lane, set) threads a block
SUFFIXES = {"none": 0, "one": 1, "full": 2}
# the segment table's fields, (L, S, len(FIELDS)) int64 (llc.cu's Field)
FIELDS = ("base", "stride", "count", "b_first", "n_pre", "sb_first", "n_suf",
          "counter", "wsel")
# a lane bucket's descriptor row, int64 (llc.cu's BucketField): six
# sizes, then the device addresses of its operands and outputs (0: no
# miss bits)
BUCKET_FIELDS = ("lanes", "n_seg", "max_sets", "max_ways", "r_pad", "suffix",
                 "table", "rounds", "geo", "hits", "tags", "ts", "miss")
_SIZES = BUCKET_FIELDS[:6]
INT32_MAX = 2**31 - 1

set_walk_launches = 0    # set_walk_kernel calls that launched, this process
lane_scan_launches = 0   # lane_scan_kernel calls that launched, this process

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The loaded library, its functions' signatures set once."""
    global _lib
    if _lib is None:
        lib = _build.library("llc")
        lib.llc_set_walk_launch.restype = ctypes.c_int
        lib.llc_set_walk_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.llc_lane_scan_launch.restype = ctypes.c_int
        lib.llc_lane_scan_launch.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p]
        for name in ("llc_max_ways", "llc_scan_threads"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        _lib = lib
    return _lib


def built_max_ways() -> int:
    """The largest way count the built library takes."""
    return _library().llc_max_ways()


def built_scan_threads() -> int:
    """The threads of a lane-scan block in the built library."""
    return _library().llc_scan_threads()


def _check(tensors: dict, dtypes: dict, what: str) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors on one CUDA "
                             f"device ({name}: {t.device}, contiguous "
                             f"{t.is_contiguous()})")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} must be {dtypes[name]}, got "
                            f"{t.dtype}")
    return dev


def set_walk_kernel(tags: torch.Tensor, age: torch.Tensor,
                    tag_s: torch.Tensor, acc_s: torch.Tensor,
                    per_set: torch.Tensor, first: torch.Tensor,
                    hit_s: torch.Tensor) -> None:
    """Launch on the current stream.  tags/age (sets, ways) int32, walked
    in place; tag_s/acc_s (n,) int32, the arrivals in set-sorted order,
    n < 2**31; per_set/first (sets,) int64, each set's arrival count and
    first position; hit_s (n,) bool, written at every arrival."""
    global set_walk_launches
    dev = _check(dict(tags=tags, age=age, tag_s=tag_s, acc_s=acc_s,
                      per_set=per_set, first=first, hit_s=hit_s),
                 dict(tags=torch.int32, age=torch.int32, tag_s=torch.int32,
                      acc_s=torch.int32, per_set=torch.int64,
                      first=torch.int64, hit_s=torch.bool),
                 "set_walk_kernel")
    sets, ways = tags.shape
    if age.shape != (sets, ways) or per_set.shape != (sets,) \
            or first.shape != (sets,) or acc_s.shape != tag_s.shape \
            or hit_s.shape != tag_s.shape or tag_s.dim() != 1:
        raise ValueError("set_walk_kernel shapes: tags/age (sets, ways), "
                         "per_set/first (sets,), tag_s/acc_s/hit_s (n,)")
    if not 1 <= ways <= MAX_WAYS or sets < 1 \
            or tag_s.shape[0] > INT32_MAX:
        raise ValueError(f"set_walk_kernel takes 1..{MAX_WAYS} ways, at "
                         f"least one set and under 2**31 arrivals, got "
                         f"{sets} sets of {ways} ways, {tag_s.shape[0]} "
                         "arrivals")
    lib = _library()
    err = lib.llc_set_walk_launch(
        tags.data_ptr(), age.data_ptr(), tag_s.data_ptr(), acc_s.data_ptr(),
        per_set.data_ptr(), first.data_ptr(), hit_s.data_ptr(), sets, ways,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "llc", err)
    set_walk_launches += 1


def bucket_sizes(table: torch.Tensor, rounds: torch.Tensor,
                 geo: torch.Tensor, *, max_sets: int, max_ways: int,
                 r_pad: int, suffix: str) -> dict:
    """One lane bucket's sizes (``BUCKET_FIELDS[:6]``), its operands'
    shapes checked: table (L, S, len(FIELDS)), rounds (S,), geo (L, 3)."""
    lanes, n_seg, n_fields = table.shape
    if n_fields != len(FIELDS) or rounds.shape != (n_seg,) \
            or geo.shape != (lanes, 3):
        raise ValueError("lane_scan shapes: table (L, S, "
                         f"{len(FIELDS)}), rounds (S,), geo (L, 3); got "
                         f"{tuple(table.shape)}, {tuple(rounds.shape)}, "
                         f"{tuple(geo.shape)}")
    if not 1 <= max_ways <= MAX_WAYS or suffix not in SUFFIXES \
            or lanes < 1 or n_seg < 1 or r_pad < 1 or max_sets < 1:
        raise ValueError(f"lane_scan takes 1..{MAX_WAYS} ways, a lane, a "
                         f"segment, r_pad >= 1, max_sets >= 1 and a suffix "
                         f"of {list(SUFFIXES)}; got {max_ways} ways, {lanes} "
                         f"lanes, {n_seg} segments, r_pad {r_pad}, max_sets "
                         f"{max_sets}, {suffix!r}")
    return dict(lanes=lanes, n_seg=n_seg, max_sets=max_sets,
                max_ways=max_ways, r_pad=r_pad, suffix=SUFFIXES[suffix])


def launch_plan(sizes: list[dict], depths: list[int],
                threads: int = SCAN_THREADS) -> np.ndarray:
    """The lane scan's block table, (n_blocks, 3) int32 rows of (bucket,
    lane, first set): every (lane, set) of every bucket's state in one
    block of ``threads`` threads, the buckets of the most rounds
    (``depths``) first, so that the deepest chains start at once."""
    order = sorted(range(len(sizes)), key=lambda b: -depths[b])
    rows = []
    for b in order:
        lanes, max_sets = sizes[b]["lanes"], sizes[b]["max_sets"]
        firsts = np.arange(0, max_sets, threads)
        rows.append(np.stack(np.broadcast_arrays(
            b, np.arange(lanes)[:, None], firsts[None, :]), -1).reshape(-1, 3))
    return np.concatenate(rows).astype(np.int32)


def lane_scan_kernel(buckets: list[tuple], outs: list[tuple],
                     depths: list[int]) -> None:
    """Launch on the current stream: every bucket in one launch.
    ``buckets``: per bucket (table (L, S, len(FIELDS)) int64, rounds (S,)
    int32, geo (L, 3) int64, sizes from ``bucket_sizes``); ``outs``: per
    bucket (hits (L, S) int64, zeros on entry, the round walk's hits
    added; miss (L, S, r_pad, max_sets) bool, zeros on entry, a round's
    miss bits set, or None; tags, ts (L, max_ways, max_sets) int32, the
    final state written from a cold start); ``depths``: each bucket's
    round count, to order the blocks.  Every field of every table fits
    int32, and each lane's sets x block bytes is under 2**32 (the lane
    engine's host checks; ``core.cache.segment_lane_scan_many``)."""
    global lane_scan_launches
    rows, dev = [], None
    for (table, rounds, geo, sizes), (hits, miss, tags, ts) in zip(buckets,
                                                                  outs):
        tensors = dict(table=table, rounds=rounds, geo=geo, hits=hits,
                       tags=tags, ts=ts)
        if miss is not None:
            tensors["miss"] = miss
        dev = _check(tensors, dict(table=torch.int64, rounds=torch.int32,
                                   geo=torch.int64, hits=torch.int64,
                                   tags=torch.int32, ts=torch.int32,
                                   miss=torch.bool), "lane_scan_kernel")
        lanes, n_seg = sizes["lanes"], sizes["n_seg"]
        state = (lanes, sizes["max_ways"], sizes["max_sets"])
        if hits.shape != (lanes, n_seg) or tags.shape != state \
                or ts.shape != state or (
                    miss is not None and miss.shape != (
                        lanes, n_seg, sizes["r_pad"], sizes["max_sets"])):
            raise ValueError("lane_scan_kernel outputs: hits (L, S), miss "
                             "(L, S, r_pad, max_sets), tags/ts (L, "
                             "max_ways, max_sets)")
        rows.append([sizes[k] for k in _SIZES] + [
            t.data_ptr() for t in (table, rounds, geo, hits, tags, ts)]
            + [0 if miss is None else miss.data_ptr()])
    if len({t.device for b in buckets for t in b[:3]}) != 1:
        raise ValueError("lane_scan_kernel takes every bucket on one device")
    plan = launch_plan([b[3] for b in buckets], depths)
    # from pinned memory, so that the copies queue behind the stream's
    # work instead of waiting for it
    desc, blocks = (torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)
                    for a in (np.asarray(rows, np.int64), plan))
    lib = _library()
    err = lib.llc_lane_scan_launch(
        desc.data_ptr(), blocks.data_ptr(), plan.shape[0],
        max(b[3]["max_ways"] for b in buckets),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "llc", err)
    lane_scan_launches += 1

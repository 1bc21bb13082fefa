"""The LLC replay engines on Hopper: launch wrappers of
``repro_torch/csrc/llc.cu`` (which says what bounds them and how they
are built).

``set_walk_kernel`` walks one geometry's set-ranked arrivals, one thread
a set (behind ``core.cache.simulate_segments``); ``lane_scan_kernel``
replays L geometries' segment streams, one thread a (lane, set) (behind
``core.cache.segment_lane_scan``).  Both take the whole replay in one
launch, where the plain loops (``ref.py``) launch about twenty small ops
a round from the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WAYS = 128       # llc.cu's kMaxWays: the widest set the kernels take
SUFFIXES = {"none": 0, "one": 1, "full": 2}
# the segment table's fields, (L, S, len(FIELDS)) int64 (llc.cu's Field)
FIELDS = ("base", "stride", "count", "b_first", "n_pre", "sb_first", "n_suf",
          "counter", "wsel")

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
        lib.llc_lane_scan_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.llc_max_ways.restype = ctypes.c_int
        lib.llc_max_ways.argtypes = []
        _lib = lib
    return _lib


def built_max_ways() -> int:
    """The largest way count the built library takes."""
    return _library().llc_max_ways()


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
    in place; tag_s/acc_s (n,) int32, the arrivals in set-sorted order;
    per_set/first (sets,) int64, each set's arrival count and first
    position; hit_s (n,) bool, written at every arrival."""
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
    if not 1 <= ways <= MAX_WAYS or sets < 1:
        raise ValueError(f"set_walk_kernel takes 1..{MAX_WAYS} ways and at "
                         f"least one set, got {sets} sets of {ways} ways")
    lib = _library()
    err = lib.llc_set_walk_launch(
        tags.data_ptr(), age.data_ptr(), tag_s.data_ptr(), acc_s.data_ptr(),
        per_set.data_ptr(), first.data_ptr(), hit_s.data_ptr(), sets, ways,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "llc", err)
    set_walk_launches += 1


def lane_scan_kernel(table: torch.Tensor, rounds: torch.Tensor,
                     geo: torch.Tensor, tags: torch.Tensor, ts: torch.Tensor,
                     hits: torch.Tensor, miss: torch.Tensor | None, *,
                     r_pad: int, suffix: str) -> None:
    """Launch on the current stream.  table (L, S, len(FIELDS)) int64,
    each lane's segments' plan; rounds (S,) int32, each segment's round
    count; geo (L, 3) int64, each lane's (sets, ways, block bytes);
    tags/ts (L, max_ways, max_sets) int32, walked in place; hits (L, S)
    int64, the round walk's hits added; miss (L, S, r_pad, max_sets)
    bool, zeros on entry, a round's miss bits set (or None)."""
    global lane_scan_launches
    tensors = dict(table=table, rounds=rounds, geo=geo, tags=tags, ts=ts,
                   hits=hits)
    dtypes = dict(table=torch.int64, rounds=torch.int32, geo=torch.int64,
                  tags=torch.int32, ts=torch.int32, hits=torch.int64,
                  miss=torch.bool)
    if miss is not None:
        tensors["miss"] = miss
    _check(tensors, dtypes, "lane_scan_kernel")
    lanes, n_seg, n_fields = table.shape
    _, max_ways, max_sets = tags.shape
    if n_fields != len(FIELDS) or rounds.shape != (n_seg,) \
            or geo.shape != (lanes, 3) or tags.shape[0] != lanes \
            or ts.shape != tags.shape or hits.shape != (lanes, n_seg) \
            or (miss is not None
                and miss.shape != (lanes, n_seg, r_pad, max_sets)):
        raise ValueError("lane_scan_kernel shapes: table (L, S, "
                         f"{len(FIELDS)}), rounds (S,), geo (L, 3), "
                         "tags/ts (L, max_ways, max_sets), hits (L, S), "
                         "miss (L, S, r_pad, max_sets)")
    if not 1 <= max_ways <= MAX_WAYS or suffix not in SUFFIXES \
            or not 1 <= lanes <= 65535 or r_pad < 1:
        raise ValueError(f"lane_scan_kernel takes 1..{MAX_WAYS} ways, "
                         f"1..65535 lanes and a suffix of {list(SUFFIXES)}; "
                         f"got {max_ways} ways, {lanes} lanes, {suffix!r}")
    lib = _library()
    err = lib.llc_lane_scan_launch(
        table.data_ptr(), rounds.data_ptr(), geo.data_ptr(), tags.data_ptr(),
        ts.data_ptr(), hits.data_ptr(),
        None if miss is None else miss.data_ptr(), lanes, n_seg, max_sets,
        max_ways, r_pad, SUFFIXES[suffix],
        torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, "llc", err)
    lane_scan_launches += 1

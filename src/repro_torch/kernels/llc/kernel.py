"""The LLC replay engines on Hopper: launch wrappers of
``repro_torch/csrc/llc.cu`` (which says what bounds them and how they
are built).

``set_walk_kernel`` walks one geometry's set-ranked arrivals (behind
``core.cache.simulate_segments``, ``simulate_trace`` and the FAME-1
stream): up to ``THREAD_WAYS`` ways one walker warp a block and a set a
lane, wider sets a warp a set, its ways in registers up to ``REG_WAYS``,
in shared memory while 8 bytes a way fit ``SHARED_BYTES``, else in
global memory.  ``lane_scan_kernel`` replays every lane bucket of a call
(behind ``core.cache.segment_lane_scan_many``), its blocks mapped by the
host-built ``launch_plan``: buckets of up to ``THREAD_WAYS`` ways one
thread a (bucket, lane, set) in one launch, wider buckets one warp a
(bucket, lane, set) in a second launch (``lane_scan_launches`` counts
each), the set's slot (``wide_slot_bytes``) in shared memory where it
fits, else in a global scratch.  Each replay is one launch a route,
where the plain loops (``ref.py``) launch about twenty small ops a
round from the host.  Any way count runs: the limits left are the
card's memory (``ops`` checks it) and int32 indexing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

THREAD_WAYS = 128    # llc.cu's kThreadWays: the widest set a thread walks
REG_WAYS = 256       # llc.cu's kRegWays: a warp's widest set in registers
SHARED_BYTES = 227 * 1024   # llc.cu's kSharedBytes: a block's shared memory
TRIP_WAYS = 32 * 4   # llc.cu's 32 x kTripWays: a warp's ways a loop trip
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
        lib.llc_lane_scan_wide_launch.restype = ctypes.c_int
        lib.llc_lane_scan_wide_launch.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        lib.llc_wide_slot_bytes.restype = ctypes.c_longlong
        lib.llc_wide_slot_bytes.argtypes = [ctypes.c_int]
        for name in ("llc_thread_ways", "llc_reg_ways", "llc_shared_bytes",
                     "llc_scan_threads"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = []
        _lib = lib
    return _lib


def built_bounds() -> tuple[int, int, int]:
    """The built library's (THREAD_WAYS, REG_WAYS, SHARED_BYTES)."""
    lib = _library()
    return lib.llc_thread_ways(), lib.llc_reg_ways(), lib.llc_shared_bytes()


def built_wide_slot_bytes(ways: int) -> int:
    """``wide_slot_bytes`` as the built library computes it."""
    return _library().llc_wide_slot_bytes(ways)


def wide_slot_bytes(ways: int) -> int:
    """A lane-scan warp route's slot for a set of ``ways`` ways: tags and
    stamps (int32, the ways rounded up to even) and a 64-bit sort key for
    each of the ways rounded up to a power of two (llc.cu's)."""
    return 8 * (ways + (ways & 1)) + 8 * (1 << max(0, ways - 1).bit_length())


def set_walk_route(ways: int) -> str:
    """The set walk's route for ``ways``: "thread" (a set a lane),
    "registers", "shared" or "global" (a set a warp, its state there)."""
    if ways <= THREAD_WAYS:
        return "thread"
    if ways <= REG_WAYS:
        return "registers"
    return "shared" if 8 * ways <= SHARED_BYTES else "global"


def built_scan_threads() -> int:
    """The threads of a lane-scan block in the built library."""
    return _library().llc_scan_threads()


def check_int32(**counts: int) -> None:
    """Raise unless every count fits the kernels' int32 indexing (under
    2**31, less a warp's stride for the ways a lane walks)."""
    for name, n in counts.items():
        if n > INT32_MAX - 32:
            raise ValueError(f"the LLC kernels index in int32: {n:,} {name} "
                             f"is past 2**31 - 32")


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


def _upload(array: np.ndarray, dev) -> torch.Tensor:
    """``array`` on ``dev`` by way of pinned memory, so that the copy
    queues behind the stream's work instead of waiting for it."""
    return torch.from_numpy(array).pin_memory().to(dev, non_blocking=True)


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
    if ways < 1 or sets < 1:
        raise ValueError(f"set_walk_kernel takes a way and a set, got {sets} "
                         f"sets of {ways} ways")
    check_int32(ways=ways, sets=sets, arrivals=tag_s.shape[0])
    lib = _library()
    with _build.launch_stream(dev) as stream:
        err = lib.llc_set_walk_launch(
            tags.data_ptr(), age.data_ptr(), tag_s.data_ptr(),
            acc_s.data_ptr(), per_set.data_ptr(), first.data_ptr(),
            hit_s.data_ptr(), sets, ways, stream)
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
    if max_ways < 1 or suffix not in SUFFIXES \
            or lanes < 1 or n_seg < 1 or r_pad < 1 or max_sets < 1:
        raise ValueError(f"lane_scan takes a way, a lane, a segment, r_pad "
                         f">= 1, max_sets >= 1 and a suffix of "
                         f"{list(SUFFIXES)}; got {max_ways} ways, {lanes} "
                         f"lanes, {n_seg} segments, r_pad {r_pad}, max_sets "
                         f"{max_sets}, {suffix!r}")
    check_int32(ways=max_ways, sets=max_sets, segments=n_seg,
                **{"(lane, set) blocks": lanes * max_sets})
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


def route_plans(sizes: list[dict], depths: list[int]) -> list[tuple]:
    """The lane scan's launches for buckets ``sizes``: (wide, the
    buckets' indices, block table) for the thread route (buckets of up
    to ``THREAD_WAYS`` ways; rows (bucket, lane, first set) of
    ``SCAN_THREADS``) and then the warp route (wider buckets; rows
    (bucket, lane, set), a warp each), each only where it has buckets."""
    out = []
    for wide in (False, True):
        which = [i for i, sz in enumerate(sizes)
                 if (sz["max_ways"] > THREAD_WAYS) == wide]
        if which:
            plan = launch_plan([sizes[i] for i in which],
                               [depths[i] for i in which],
                               1 if wide else SCAN_THREADS)
            plan[:, 0] = np.asarray(which, np.int32)[plan[:, 0]]
            out.append((wide, which, plan))
    return out


def wide_scratch_bytes(sizes: list[dict]) -> int:
    """The warp route's global scratch for lane buckets ``sizes`` (from
    ``bucket_sizes``): a slot a (bucket, lane, set) of the buckets wider
    than ``THREAD_WAYS`` when their widest slot does not fit shared
    memory, else 0."""
    wide = [sz for sz in sizes if sz["max_ways"] > THREAD_WAYS]
    if not wide:
        return 0
    slot = wide_slot_bytes(max(sz["max_ways"] for sz in wide))
    if slot <= SHARED_BYTES:
        return 0
    return slot * sum(sz["lanes"] * sz["max_sets"] for sz in wide)


def lane_scan_kernel(buckets: list[tuple], outs: list[tuple],
                     depths: list[int]) -> None:
    """Launch on the current stream: buckets of up to ``THREAD_WAYS``
    ways in one launch of the thread route, wider buckets in one launch
    of the warp route (two launches when a call has both, each counted).
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
    sizes = [b[3] for b in buckets]
    lib = _library()
    with _build.launch_stream(dev) as stream:
        desc = _upload(np.asarray(rows, np.int64), dev)
        for wide, which, plan in route_plans(sizes, depths):
            check_int32(blocks=plan.shape[0])
            blocks = _upload(plan, dev)
            widest = max(sizes[i]["max_ways"] for i in which)
            if wide:
                nbytes = wide_scratch_bytes([sizes[i] for i in which])
                scratch = torch.empty(nbytes, dtype=torch.uint8,
                                      device=dev) if nbytes else None
                err = lib.llc_lane_scan_wide_launch(
                    desc.data_ptr(), blocks.data_ptr(), plan.shape[0],
                    widest, None if scratch is None else scratch.data_ptr(),
                    stream)
            else:
                err = lib.llc_lane_scan_launch(
                    desc.data_ptr(), blocks.data_ptr(), plan.shape[0],
                    widest, stream)
            _build.check(lib, "llc", err)
            lane_scan_launches += 1

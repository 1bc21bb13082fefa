"""Set-associative LLC simulator — exact, lane-batched, runtime-configurable.

The FireSim LLC model is runtime-configurable in sets/ways/block size
without an FPGA rebuild; this is the same knob set, in PyTorch.  Three
execution paths, bit-identical in hit counts:

* **exact per-access scan** (``simulate_trace``): one true-LRU update
  per access — the reference semantics, the parity oracle of the
  engines below.  On ``cuda`` the trace is one ``llc_set_walk`` launch
  (every access an arrival of count 1, from a cold state); on the CPU a
  Python loop, its plain version (``hit_rate`` replays the same trace
  through the segment engine);
* **segment engine** (``simulate_segments``): one geometry, per-set
  rounds over block arrivals, with per-segment hits, exact miss runs
  for the DRAM row model, and warm-state continuation — what the
  serving oracle's interference lanes run on;
* **segment-lane engine** (``segment_lane_scan``): a DBB stream is
  run-length-compressed into ``(base, stride, count)`` segments
  (``repro_torch.core.traces``) and replayed segment by segment, with a
  leading *lane* dimension that carries one cache geometry per lane, so
  a whole Fig. 5 grid replays in one pass over the trace
  (``repro_torch.core.sweep.segment_lane_hit_counts``).

The two engines plan on the host and replay on the device through
``repro_torch.kernels.llc``: on a CUDA device each replay is one launch
of a hand-written kernel (``csrc/llc.cu``: ``llc_set_walk``,
``llc_lane_scan``), on the CPU the plain round loops.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.llc import kernel as llc_kernel
from repro_torch.kernels.llc import ops as llc_ops
from repro_torch.utils.address import fdiv, first_access, last_access
from repro_torch.utils.env import check_address_range, default_device

_I32 = np.iinfo(np.int32)


@dataclasses.dataclass(frozen=True)
class LLCConfig:
    size_bytes: int = 2 * 1024 * 1024
    ways: int = 8
    block_bytes: int = 64

    @property
    def sets(self) -> int:
        return max(1, self.size_bytes // (self.ways * self.block_bytes))


def block_address(byte_addr, block_bytes: int):
    return byte_addr // block_bytes


def cold_state(sets: int, ways: int, *, device=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (tags, age) state of an empty cache, (sets, ways) int32 each."""
    dev = default_device(device)
    return (torch.full((sets, ways), -1, dtype=torch.int32, device=dev),
            torch.zeros((sets, ways), dtype=torch.int32, device=dev))


def simulate_trace(block_addrs, *, sets: int, ways: int,
                   device=None) -> np.ndarray:
    """block_addrs (T,) -> hits (T,) bool.  True-LRU, allocate-on-miss
    (writes allocate too — NVDLA's DBB read/write bursts both fill).  A
    hit touches the first matching way; a miss evicts the first way of
    greatest age; the touched way's age resets to 0 and every other way
    of the set ages by one.  Runs on ``device`` (``cuda`` when None): on
    the card one ``llc_set_walk`` launch over the trace ranked by set
    (``walk_by_set``), each access an arrival of count 1 from
    ``cold_state``, the hits brought back in one copy; on the CPU the
    list loop below, the plain version.  Tags (``block // sets``) are
    int32, as the reference casts them: a trace whose tags leave int32
    raises ``OverflowError`` on either route."""
    dev = default_device(device)
    blocks = np.asarray(block_addrs, np.int64).reshape(-1)
    if blocks.size and not (_I32.min <= blocks.min() // sets
                            and blocks.max() // sets <= _I32.max):
        raise OverflowError(
            f"simulate_trace's tags (block // {sets} sets) are int32, as the "
            f"reference's: blocks {int(blocks.min())}..{int(blocks.max())} "
            "leave that range")
    block = torch.as_tensor(blocks, device=dev)
    if _on_card(block):
        hit, _, _ = walk_by_set(
            *cold_state(sets, ways, device=dev), torch.remainder(block, sets),
            fdiv(block, sets).to(torch.int32),
            torch.ones(blocks.shape[0], dtype=torch.int32, device=dev))
        return hit.cpu().numpy()
    tags, age = (s.tolist() for s in cold_state(sets, ways, device="cpu"))
    hits = []
    for b in blocks.tolist():
        s, t = b % sets, b // sets
        row_t, row_a = tags[s], age[s]
        hit = t in row_t
        way = row_t.index(t) if hit else row_a.index(max(row_a))
        row_t[way] = t
        age[s] = [0 if q == way else a + 1 for q, a in enumerate(row_a)]
        hits.append(hit)
    return np.asarray(hits, bool)


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA device, where ``simulate_trace`` takes
    the kernel route."""
    return x.device.type == "cuda"


def hit_rate(block_addrs, cfg: LLCConfig, *, device=None) -> float:
    """Exact LLC hit rate of a per-access block-address trace, replayed
    on ``device`` (``cuda`` when None): every access is one arrival of
    the per-set round engine (``simulate_segments``, one ``llc_set_walk``
    launch on the card at any way count), so the hits are
    ``simulate_trace``'s.  The rate is float32 as the reference's mean
    computes it: the hit count times the float32 reciprocal of the
    access count."""
    bb = cfg.block_bytes
    blocks = np.asarray(block_addrs, np.int64).reshape(-1)
    res = simulate_segments([(b * bb, bb, 1) for b in blocks.tolist()],
                            cfg, device=device)
    return float(np.float32(res.hits)
                 * (np.float32(1) / np.float32(blocks.shape[0])))


def sequential_burst_trace(n_bursts: int, burst_bytes: int,
                           block_bytes: int, base: int = 0, *,
                           device=None) -> torch.Tensor:
    """Byte-sequential stream of `burst_bytes` bursts -> block addresses
    (the NVDLA weight/ifmap streaming pattern), an int64 tensor on
    ``device`` (``cuda`` when None)."""
    dev = default_device(device)
    byte_addrs = base + torch.arange(n_bursts, device=dev) * burst_bytes
    return block_address(byte_addrs, block_bytes)


class _TouchedBlocks:
    """Host-side conservative residency tracker: the union of block
    intervals any earlier segment touched.  A segment disjoint from
    every touched interval provably has no resident blocks, so its
    disjointness can be decided without a device sync (the price of
    conservatism: a revisit of a long-evicted range still takes the
    round-scan path — exact either way)."""

    def __init__(self):
        self._iv: list[tuple[int, int]] = []   # merged, sorted

    def overlaps(self, lo: int, hi: int) -> bool:
        return any(a <= hi and lo <= b for a, b in self._iv)

    def add(self, lo: int, hi: int) -> None:
        merged = [(lo, hi)]
        for a, b in self._iv:
            if a <= merged[0][1] + 1 and merged[0][0] <= b + 1:
                merged[0] = (min(a, merged[0][0]), max(b, merged[0][1]))
            else:
                merged.append((a, b))
        self._iv = sorted(merged)


# --------------------------------------------------------------------------
# segment-lane engine: geometry as per-lane operands
# --------------------------------------------------------------------------
def _lane_plan_tables(bases, strides, counts, r_needed, cold, sets, ways,
                      block_bytes, way_sels=None, *, r_pad: int,
                      suffix: str = "full"):
    """``segment_lane_scan``'s host plan as the engine's operands: the
    (L, S, len(FIELDS)) int64 segment table (``kernels.llc.kernel.FIELDS``:
    block ranges, the round-scanned prefix and closed-form suffix split,
    the timestamp counter, the allocation mask, 0 where unpartitioned),
    the (S,) int32 round counts, the (L, 3) int64 geometries (sets, ways,
    block bytes) and the (L, S) int64 suffix hits, which are known on the
    host."""
    sets_h = np.asarray(sets, np.int64)[:, None]
    ways_h = np.asarray(ways, np.int64)[:, None]
    bb_h = np.asarray(block_bytes, np.int64)[:, None]
    n_lane = sets_h.shape[0]
    shape = (n_lane, np.shape(counts)[-1])
    base, stride, count = (np.broadcast_to(np.asarray(a, np.int64), shape)
                           for a in (bases, strides, counts))
    cold = np.broadcast_to(np.asarray(cold, bool), shape)
    rounds = np.minimum(np.broadcast_to(r_needed, shape).max(axis=0), r_pad)
    wsel = np.broadcast_to(np.asarray(0 if way_sels is None else way_sels,
                                      np.int64), shape)

    live = count > 0
    b_first = base // bb_h
    b_last = (base + (count - 1) * stride) // bb_h
    n_blocks = np.where(live, b_last - b_first + 1, 0)
    n_pre = np.where(cold, 0, np.minimum(n_blocks, ways_h * sets_h))
    # a partitioned segment cannot use the suffix closed form (victims
    # cycle within its mask, not all ways)
    n_pre = np.where(wsel != 0, n_blocks, n_pre)
    sb_first = b_first + n_pre
    n_suf = np.maximum(n_blocks - n_pre, 0)
    has_suf = (n_suf > 0) & (suffix != "none")
    lo = sb_first * bb_h - base
    first_suf = np.where(lo <= 0, 0, (lo + stride - 1) // stride)
    j_split = np.where(has_suf, first_suf, count)
    suf_hits = np.where(has_suf, (count - j_split) - n_suf, 0)
    live_count = np.where(live, count, 0)
    counter = np.cumsum(live_count, axis=1) - live_count
    fields = dict(base=base, stride=stride, count=count, b_first=b_first,
                  n_pre=n_pre, sb_first=sb_first, n_suf=n_suf,
                  counter=counter, wsel=wsel)
    table = np.stack([fields[f] for f in llc_kernel.FIELDS], axis=-1)
    geo = np.concatenate([sets_h, ways_h, bb_h], axis=1)
    return (table.astype(np.int64), rounds.astype(np.int32), geo,
            suf_hits.astype(np.int64))


@dataclasses.dataclass(frozen=True)
class LaneBatch:
    """One lane batch of the segment-lane engine: ``segment_lane_scan``'s
    arguments (its docstring says what each is)."""
    bases: object
    strides: object
    counts: object
    r_needed: object
    cold: object
    sets: object
    ways: object
    block_bytes: object
    way_sels: object = None
    max_sets: int = 1
    max_ways: int = 1
    r_pad: int = 1
    suffix: str = "full"


def segment_lane_scan(bases, strides, counts, r_needed, cold,
                      sets, ways, block_bytes, way_sels=None, *,
                      max_sets: int, max_ways: int, r_pad: int,
                      collect: bool = False, suffix: str = "full",
                      return_state: bool = False, device=None):
    """Exact segment replay of L lanes, each with its own geometry.

    ``bases/strides/counts`` are (L, S) or (1, S) int segment streams
    (count == 0 entries are padding and update nothing); ``sets/ways/
    block_bytes`` are (L,) geometries, padded in the state to
    ``max_sets``/``max_ways``.  ``r_needed`` ((L, S) or (S,)) and
    ``cold`` ((L, S) or (S,)) are the host-side execution plan
    (``repro_torch.core.sweep._lane_plan``): the round-scan rounds each
    segment needs in each lane (capped at ``r_pad``; extra rounds are
    masked no-ops, missing rounds would be wrong) and whether its byte
    range is provably disjoint from everything replayed before it.

    Per segment the update is an exact decomposition:

    * a per-set round scan retires the first min(n_blocks, ways*sets)
      blocks (one block per set per round, all intra-block burst repeats
      folded into one LRU touch) — zero for a ``cold`` segment, whose
      arrivals provably all miss;
    * the rest of the segment finishes with a closed-form suffix: after
      `ways` arrivals in every set the cache provably holds exactly
      those arrivals, so every suffix block misses and victims cycle
      through the ways oldest-first.  The final occupants and their
      last-touch timestamps are written directly.

    ``suffix`` specializes the closed-form suffix from the host plan:
    ``"full"`` is the general oldest-first rank insert; ``"one"`` (every
    suffix leaves at most one block per set) a plain oldest-way
    eviction, O(ways) per set instead of O(ways^2); ``"none"`` (every
    segment retires entirely in the round scan) drops the suffix.

    ``way_sels`` ((L, S) or (S,) int, optional) adds LLC **way-masking
    partitioning** (Intel CAT semantics): a per-segment bitmask of the
    ways the segment's master may *allocate* into on a miss.  Hits are
    unrestricted — only victim selection is confined to the mask.  A
    zero mask means "unpartitioned" (the full-mask behaviour, bit
    -exactly), so one batch mixes masked and unmasked lanes.  Masked
    segments retire entirely in the round scan (the suffix assumes
    unrestricted victim cycling), so the plan must give them
    ``ceil(n_blocks / sets)`` rounds, and their ``cold`` flag is
    ignored.

    LRU is tracked as a global last-touch timestamp (int32, as are the
    tags): recency order, and so every victim choice including
    first-index tie-breaks, is the per-set age order of
    ``simulate_trace``.  State is (L, max_ways, max_sets).  Everything
    that depends only on the trace and the geometry — block ranges,
    prefix/suffix split, suffix hits, allocation masks and the timestamp
    counter (a prefix sum of counts) — is planned on the host; the
    device runs the round scans and the suffix inserts, and the results
    come back once, at the end.  Requires stride <= block_bytes and
    int32-range addresses (the caller checks).

    Returns (L, S) int64 per-segment hit counts, bit-identical to
    expanding the trace and running the per-access scan at each lane's
    geometry; with ``collect`` also the round-scan miss bits, (L, S,
    r_pad, max_sets) bool — entry [l, j, k, s] is set iff round k of
    segment j missed in set s of lane l; with ``return_state`` also the
    final ``(tags, ts)``, (L, max_ways, max_sets) int32 each — the
    reference's per-lane layout.
    """
    return segment_lane_scan_many(
        [LaneBatch(bases, strides, counts, r_needed, cold, sets, ways,
                   block_bytes, way_sels, max_sets=max_sets,
                   max_ways=max_ways, r_pad=r_pad, suffix=suffix)],
        collect=collect, return_state=return_state, device=device)[0]


def segment_lane_scan_many(batches: list[LaneBatch], *,
                           collect: bool = False, return_state: bool = False,
                           device=None) -> list:
    """``segment_lane_scan`` of several lane batches (``LaneBatch``, e.g.
    the lane buckets of one sweep) in one replay: on a CUDA device one
    launch of ``llc_lane_scan`` for all of them, so the call costs its
    longest chain and not the sum of the batches', and the results come
    back to the host in one copy; on the CPU the plain loop a batch.
    Returns each batch's ``segment_lane_scan`` result, bit for bit."""
    dev = default_device(device)
    plans, suf_hits, depths = [], [], []
    for b in batches:
        if b.suffix not in ("full", "one", "none"):
            raise ValueError(f"suffix must be 'full', 'one' or 'none', got "
                             f"{b.suffix!r}")
        table, rounds, geo, suf = _lane_plan_tables(
            b.bases, b.strides, b.counts, b.r_needed, b.cold, b.sets,
            b.ways, b.block_bytes, b.way_sels, r_pad=b.r_pad,
            suffix=b.suffix)
        for name, what in (("base", "segment base"),
                           ("b_first", "segment first block"),
                           ("sb_first", "segment suffix block")):
            check_address_range(table[:, :, llc_kernel.FIELDS.index(name)],
                                what)
        _check_lane_table(table, geo)
        plans.append((torch.as_tensor(table, device=dev),
                      torch.as_tensor(rounds, device=dev),
                      torch.as_tensor(geo, device=dev), b.max_sets,
                      b.max_ways, b.r_pad, b.suffix))
        suf_hits.append(suf)
        depths.append(int(rounds.sum()))
    results = llc_ops.lane_scan_many(plans, collect=collect, host=True,
                                     depths=depths)
    out = []
    for suf, (round_hits, miss, tags, ts) in zip(suf_hits, results):
        res = (suf + round_hits.numpy(),)
        if collect:
            res += (miss.numpy(),)
        if return_state:
            res += ((tags.numpy(), ts.numpy()),)
        out.append(res if len(res) > 1 else res[0])
    return out


def _check_lane_table(table: np.ndarray, geo: np.ndarray) -> None:
    """The lane engine's int32 support on its host plan: every field of
    the segment table in int32 range and each lane's sets x block bytes
    under 2**32, as ``llc_lane_scan``'s 32-bit arithmetic needs (the
    callers' checks, ``sweep._check_lane_support_meta``, guarantee it
    for the traces they take)."""
    i32 = np.iinfo(np.int32)
    fields = table[:, :, :llc_kernel.FIELDS.index("wsel")]
    if fields.size and (fields.min() < i32.min or fields.max() > i32.max):
        raise OverflowError("segment-lane plan leaves int32 range — the "
                            "lane engine keeps addresses, blocks and "
                            "timestamps in 32 bits; rebase or split the "
                            "trace")
    if np.any(geo < 1) or np.any(geo[:, 0] * geo[:, 2] >= 2**32):
        raise ValueError(f"lane geometries must be positive with sets x "
                         f"block bytes under 2**32, got {geo.tolist()}")


# --------------------------------------------------------------------------
# single-geometry segment engine with per-segment hits and miss runs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SegmentSimResult:
    hits: int
    accesses: int
    state: tuple                 # final (tags, age), (sets, ways) int32
    per_segment_hits: np.ndarray | None = None   # (n_segments,) int64
    miss_runs: list | None = None  # [(first_block, n_blocks, seg_idx)]

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)


def _split_blocks(base, stride, count, sets: int, ways: int, bb: int,
                  warm: bool) -> np.ndarray:
    """The block at which the reference engine splits a long segment
    that revisits touched blocks into a round-scanned prefix and a
    closed-form suffix (-1 where it does not split).  The split shows in
    the miss runs, which the reference emits per part."""
    live = count > 0
    b_first = base // bb
    b_last = (base + np.maximum(count - 1, 0) * stride) // bb
    uniform = np.remainder(bb, np.maximum(stride, 1)) == 0
    split = np.full(base.shape[0], -1, np.int64)
    long = live & (stride <= bb) & uniform & \
        (b_last - b_first + 1 >= 2 * (ways + 1) * sets)
    for j in np.flatnonzero(long):
        # touched: a warm start, or any earlier live segment's blocks
        if warm or np.any(live[:j] & (b_first[:j] <= b_last[j])
                          & (b_last[:j] >= b_first[j])):
            split[j] = b_first[j] + (ways + 1) * sets
    return split


def walk_by_set(tags, age, set_a, tag_a, acc):
    """One ``llc_set_walk`` over arrivals in trace order: ``set_a`` (N,)
    int64 set of each arrival, ``tag_a`` (N,) int32 tag, ``acc`` (N,)
    access count, from the state (tags, age) (sets, ways) int32.  Every
    arrival is ranked within its set by a stable sort; round r takes
    position first[s] + r of the set-sorted order.  Returns (hit (N,)
    bool in arrival order, tags, age)."""
    order = torch.sort(set_a, stable=True).indices
    per_set = torch.bincount(set_a, minlength=tags.shape[0])
    hit_s, tags, age = llc_ops.set_walk(
        tags, age, tag_a[order], acc[order].to(torch.int32), per_set,
        torch.cumsum(per_set, 0) - per_set)
    hit = torch.empty_like(hit_s)
    hit[order] = hit_s
    return hit, tags, age


def simulate_segments(segments, cfg: LLCConfig, state=None, *,
                      per_segment: bool = False,
                      collect_miss_runs: bool = False,
                      device=None) -> SegmentSimResult:
    """Replay a compressed DBB trace (iterable of objects/tuples with
    ``base, stride, count`` in bytes/bursts, stride > 0) through the
    LLC on ``device`` (``cuda`` when None), optionally continuing from a
    prior (tags, age) ``state``.

    Sets are independent under LRU, and all accesses of one segment to
    one block are consecutive in the trace, so the replay runs per set:
    every block a segment touches is one *arrival* carrying its access
    count (a segment with stride > block size: one arrival per access),
    arrivals are ranked within their set in trace order, and round r
    retires the r-th arrival of every set at once — one true-LRU touch
    (hit: first matching way; miss: first way of greatest age), the
    touched way's age reset, every other way of the set aged by the
    arrival's access count.  Serial depth is the largest number of
    arrivals any set receives, not the number of segments or accesses.
    Hit counts, final state, ``per_segment`` hits and
    ``collect_miss_runs`` runs (maximal runs of consecutive missed
    blocks per segment, in access order) are bit-identical to the
    reference's ``simulate_segments``, and so to expanding the trace and
    running the per-access ``simulate_trace``."""
    from repro_torch.core.traces import segment_tuple

    dev = default_device(device)
    sets, ways, bb = cfg.sets, cfg.ways, cfg.block_bytes
    metas = [segment_tuple(s) for s in segments]
    arr = np.asarray(metas, np.int64).reshape(-1, 3)
    base, stride, count = arr[:, 0], arr[:, 1], arr[:, 2]
    live = count > 0
    if np.any(live & (stride <= 0)):
        raise ValueError(
            f"segment stride must be positive, got "
            f"{int(stride[live & (stride <= 0)][0])} (a repeated single "
            "address is not a compressible sequential burst stream)")
    split = _split_blocks(base, stride, count, sets, ways, bb,
                          state is not None)
    if state is None:
        tags, age = cold_state(sets, ways, device=dev)
    else:
        tags, age = (s.to(device=dev, dtype=torch.int32)
                     if isinstance(s, torch.Tensor) else
                     torch.as_tensor(np.array(s), dtype=torch.int32,
                                     device=dev) for s in state)
    accesses = int(count[live].sum())
    compress = stride <= bb
    b_first = base // bb
    b_last = (base + np.maximum(count - 1, 0) * stride) // bb
    n_arr = np.where(live, np.where(compress, b_last - b_first + 1, count),
                     0)
    n_total = int(n_arr.sum())

    # arrivals, in trace order (device)
    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=dev)

    seg_of = torch.repeat_interleave(
        torch.arange(len(metas), device=dev), col(n_arr))
    start = col(np.cumsum(n_arr) - n_arr)
    i = torch.arange(n_total, device=dev) - start[seg_of]
    base_a, stride_a, count_a = (col(a)[seg_of] for a in (base, stride,
                                                           count))
    comp_a = torch.as_tensor(compress, device=dev)[seg_of]
    block = torch.where(comp_a, col(b_first)[seg_of] + i,
                        fdiv(base_a + i * stride_a, bb))
    acc = torch.where(comp_a,
                      last_access(block, base_a, stride_a, count_a, bb)
                      - first_access(block, base_a, stride_a, bb) + 1, 1)
    set_a = torch.remainder(block, sets)
    tag_a = fdiv(block, sets).to(torch.int32)

    hit_a, tags, age = walk_by_set(tags, age, set_a, tag_a, acc)

    seg_hits = torch.zeros(len(metas), dtype=torch.int64, device=dev)
    seg_hits.index_add_(0, seg_of, acc - 1 + hit_a.to(torch.int64))
    per_seg = seg_hits.cpu().numpy()
    miss_runs = None
    if collect_miss_runs:
        miss = torch.nonzero(~hit_a).flatten()
        blk, sg = block[miss], seg_of[miss]
        cut = torch.ones(miss.shape[0], dtype=torch.bool, device=dev)
        cut[1:] = (sg[1:] != sg[:-1]) | (blk[1:] != blk[:-1] + 1)
        cut |= blk == col(split)[sg]
        starts = torch.nonzero(cut).flatten()
        lengths = torch.diff(starts, append=torch.tensor(
            [miss.shape[0]], device=dev))
        miss_runs = list(zip(blk[starts].tolist(), lengths.tolist(),
                             sg[starts].tolist()))
    return SegmentSimResult(hits=int(per_seg.sum()), accesses=accesses,
                            state=(tags, age),
                            per_segment_hits=per_seg if per_segment else None,
                            miss_runs=miss_runs)


def hit_rate_segments(segments, cfg: LLCConfig, *, device=None) -> float:
    """LLC hit rate of a compressed trace (exact)."""
    return simulate_segments(segments, cfg, device=device).hit_rate

"""Set-associative LLC simulator — exact, lane-batched, runtime-configurable.

The FireSim LLC model is runtime-configurable in sets/ways/block size
without an FPGA rebuild; this is the same knob set, in PyTorch.  Three
execution paths, bit-identical in hit counts:

* **exact per-access scan** (``simulate_trace``): a Python loop, one
  true-LRU update per access — the reference semantics, used on
  unit-test traces as the parity oracle (``hit_rate`` replays the same
  per-access trace on the device through the segment engine);
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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.env import as_address_tensor, default_device

_IMAX = torch.iinfo(torch.int32).max


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


def simulate_trace(block_addrs, *, sets: int, ways: int) -> np.ndarray:
    """block_addrs (T,) -> hits (T,) bool.  True-LRU, allocate-on-miss
    (writes allocate too — NVDLA's DBB read/write bursts both fill).  A
    hit touches the first matching way; a miss evicts the first way of
    greatest age; the touched way's age resets to 0 and every other way
    of the set ages by one."""
    tags, age = (s.tolist() for s in cold_state(sets, ways, device="cpu"))
    hits = []
    for b in np.asarray(block_addrs, np.int64).tolist():
        s, t = b % sets, b // sets
        row_t, row_a = tags[s], age[s]
        hit = t in row_t
        way = row_t.index(t) if hit else row_a.index(max(row_a))
        row_t[way] = t
        age[s] = [0 if q == way else a + 1 for q, a in enumerate(row_a)]
        hits.append(hit)
    return np.asarray(hits, bool)


def hit_rate(block_addrs, cfg: LLCConfig, *, device=None) -> float:
    """Exact LLC hit rate of a per-access block-address trace, replayed
    on ``device`` (``cuda`` when None): every access is one arrival of
    the per-set round engine (``simulate_segments``), so the hits are
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
def _fdiv(a, b):
    """Floor division (the reference's ``//`` on signed operands)."""
    return torch.div(a, b, rounding_mode="floor")


def _first_access(blocks, base, stride, block_bytes):
    """Index (within the segment) of the first access landing in each of
    `blocks` (accesses are base + j*stride, j in [0, count))."""
    lo = blocks * block_bytes - base
    return torch.where(lo <= 0, 0, _fdiv(lo + stride - 1, stride))


def _last_access(blocks, base, stride, count, block_bytes):
    """Index of the last segment access landing in each of `blocks`."""
    lo = blocks * block_bytes - base
    return torch.minimum(count - 1, _fdiv(lo + block_bytes - 1, stride))


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
    if suffix not in ("full", "one", "none"):
        raise ValueError(f"suffix must be 'full', 'one' or 'none', got "
                         f"{suffix!r}")
    dev = default_device(device)
    sets_h = np.asarray(sets, np.int64)[:, None]
    ways_h = np.asarray(ways, np.int64)[:, None]
    bb_h = np.asarray(block_bytes, np.int64)[:, None]
    n_lane = sets_h.shape[0]
    shape = (n_lane, np.shape(counts)[-1])
    base, stride, count = (np.broadcast_to(np.asarray(a, np.int64), shape)
                           for a in (bases, strides, counts))
    cold = np.broadcast_to(np.asarray(cold, bool), shape)
    rounds = np.minimum(np.broadcast_to(r_needed, shape).max(axis=0), r_pad)
    masked = way_sels is not None

    # host plan, (L, S) each
    live = count > 0
    b_first = base // bb_h
    b_last = (base + (count - 1) * stride) // bb_h
    n_blocks = np.where(live, b_last - b_first + 1, 0)
    n_pre = np.where(cold, 0, np.minimum(n_blocks, ways_h * sets_h))
    if masked:
        wsel = np.broadcast_to(np.asarray(way_sels, np.int64), shape)
        # a partitioned segment cannot use the suffix closed form
        # (victims cycle within its mask, not all ways)
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

    def per_segment(a, what=None):
        """(L, S, ...) host table -> (S, L, ...) device tensor, a
        trailing unit axis added to 2-d tables: row j is segment j's
        per-lane column, a view."""
        a = np.array(np.swapaxes(a, 0, 1))
        if a.ndim == 2:
            a = a[:, :, None]
        if what is not None:
            return as_address_tensor(a, device=dev, what=what)
        return torch.as_tensor(a, device=dev)

    base_d = per_segment(base, "segment base")
    b_first_d = per_segment(b_first, "segment first block")
    sb_first_d = per_segment(sb_first, "segment suffix block")
    stride_d, count_d, n_pre_d, n_suf_d, counter_d = (
        per_segment(a) for a in (stride, count, n_pre, n_suf, counter))

    s_idx = torch.arange(max_sets, device=dev)
    q_idx = torch.arange(max_ways, device=dev)
    sets_d = torch.as_tensor(sets_h, device=dev)              # (L, 1)
    ways_d = torch.as_tensor(ways_h, device=dev)[:, :, None]  # (L, 1, 1)
    bb_d = torch.as_tensor(bb_h, device=dev)
    set_mask = s_idx[None, :] < sets_d                        # (L, MS)
    way_mask = (q_idx[None, :] < ways_d[:, :, 0])[:, :, None]  # (L, MW, 1)
    if masked:
        # per-segment allocation masks: the mask's bits limited to real
        # ways; the zero sentinel allocates anywhere real
        bits = (wsel[:, :, None] >> np.arange(max_ways)) & 1
        alloc = (np.arange(max_ways) < ways_h[:, :, None]) & (
            (wsel[:, :, None] == 0) | (bits != 0))
        alloc_d = per_segment(alloc)[:, :, :, None]            # (S, L, MW, 1)
    # [a, b]: way b precedes way a in a tie (stable oldest-first rank)
    earlier_way = (q_idx[None, :] < q_idx[:, None])[None, :, :, None]
    tags = torch.full((n_lane, max_ways, max_sets), -1, dtype=torch.int32,
                      device=dev)
    ts = torch.zeros_like(tags)
    miss = (torch.zeros((n_lane, shape[1], r_pad, max_sets),
                        dtype=torch.bool, device=dev) if collect else None)

    hit_segs, hit_rows = [], []
    for j in range(shape[1]):
        if not live[:, j].any():
            continue
        base_j, stride_j, count_j = base_d[j], stride_d[j], count_d[j]
        counter_j = counter_d[j]
        if rounds[j] > 0:
            b_first_j, n_pre_j = b_first_d[j], n_pre_d[j]
            alloc_j = alloc_d[j] if masked else way_mask
            off = torch.where(set_mask,
                              torch.remainder(s_idx - b_first_j, sets_d), 0)
            hits = torch.zeros(n_lane, dtype=torch.int64, device=dev)
            for k in range(int(rounds[j])):
                i = off + k * sets_d          # block ordinal within segment
                v = set_mask & (i < n_pre_j)
                blocks = b_first_j + i
                t = _fdiv(blocks, sets_d).to(torch.int32)
                j_lo = _first_access(blocks, base_j, stride_j, bb_d)
                j_hi = _last_access(blocks, base_j, stride_j, count_j, bb_d)
                # the touched way: a matching tag wins outright (key -1,
                # unique per set), else the oldest way it may allocate
                # into; the cumsum first-min mask is argmin's first-index
                # tie-break
                key = torch.where(tags == t[:, None, :], -1,
                                  torch.where(alloc_j, ts, _IMAX))
                kmin = key.amin(dim=1)
                hit = kmin == -1
                is_min = key == kmin[:, None, :]
                first_min = (is_min.cumsum(dim=1) == 1) & is_min
                touched = first_min & v[:, None, :]
                tags = torch.where(touched, t[:, None, :], tags)
                stamp = (counter_j + j_hi + 1).to(torch.int32)
                ts = torch.where(touched, stamp[:, None, :], ts)
                hits = hits + torch.where(v, j_hi - j_lo + hit, 0).sum(dim=1)
                if collect:
                    miss[:, j, k] = v & ~hit
            hit_segs.append(j)
            hit_rows.append(hits)
        if not has_suf[:, j].any():
            continue
        # closed-form suffix: everything past the round-scanned prefix
        # (the whole segment when cold)
        sb_first_j, n_suf_j = sb_first_d[j], n_suf_d[j]
        off_suf = torch.where(set_mask,
                              torch.remainder(s_idx - sb_first_j, sets_d), 0)
        victim_ts = torch.where(way_mask, ts, _IMAX)
        if suffix == "one":
            # at most one suffix block per set: it evicts the oldest way
            # (min ts, first-index tie-break)
            ins = set_mask & (off_suf < n_suf_j)
            is_old = victim_ts == victim_ts.amin(dim=1, keepdim=True)
            oldest = (is_old.cumsum(dim=1) == 1) & is_old
            blk1 = sb_first_j + off_suf
            t1 = _fdiv(blk1, sets_d).to(torch.int32)
            ts1 = (counter_j + _last_access(blk1, base_j, stride_j, count_j,
                                            bb_d) + 1).to(torch.int32)
            wr = oldest & ins[:, None, :]
            tags = torch.where(wr, t1[:, None, :], tags)
            ts = torch.where(wr, ts1[:, None, :], ts)
            continue
        m_s = torch.where(off_suf < n_suf_j,
                          _fdiv(n_suf_j - off_suf + sets_d - 1, sets_d), 0)
        # each way's rank in oldest-first recency order (stable: ties
        # break on way index)
        vt_a, vt_b = victim_ts[:, :, None, :], victim_ts[:, None, :, :]
        older = (vt_b < vt_a) | ((vt_b == vt_a) & earlier_way)
        rank = older.sum(dim=2)
        m3 = m_s[:, None, :]
        jstar = m3 - torch.remainder(m3 - 1 - rank, ways_d)
        valid_q = way_mask & (jstar >= 1) & set_mask[:, None, :]
        sets3 = sets_d[:, :, None]
        blk = sb_first_j[:, :, None] + off_suf[:, None, :] + (jstar - 1) * sets3
        t_star = _fdiv(blk, sets3).to(torch.int32)
        last = _last_access(blk, base_j[:, :, None], stride_j[:, :, None],
                            count_j[:, :, None], bb_d[:, :, None])
        ts_star = (counter_j[:, :, None] + last + 1).to(torch.int32)
        tags = torch.where(valid_q, t_star, tags)
        ts = torch.where(valid_q, ts_star, ts)

    hits_out = suf_hits.astype(np.int64)
    if hit_rows:
        hits_out[:, hit_segs] += torch.stack(hit_rows, dim=1).cpu().numpy()
    out = (hits_out,)
    if collect:
        out += (miss.cpu().numpy(),)
    if return_state:
        out += ((tags.cpu().numpy(), ts.cpu().numpy()),)
    return out if len(out) > 1 else out[0]


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
                        _fdiv(base_a + i * stride_a, bb))
    acc = torch.where(comp_a,
                      _last_access(block, base_a, stride_a, count_a, bb)
                      - _first_access(block, base_a, stride_a, bb) + 1, 1)
    set_a = torch.remainder(block, sets)
    tag_a = _fdiv(block, sets).to(torch.int32)

    # rank every arrival within its set; round r takes position
    # first[s] + r of the set-sorted order
    order = torch.sort(set_a, stable=True).indices
    per_set = torch.bincount(set_a, minlength=sets)
    first = torch.cumsum(per_set, 0) - per_set
    tag_s, acc_s = tag_a[order], acc[order].to(torch.int32)
    hit_s = torch.zeros(n_total + 1, dtype=torch.bool, device=dev)
    rounds = int(per_set.max()) if n_total else 0
    for r in range(rounds):
        pos = first + r
        v = per_set > r
        pick = torch.clamp(pos, max=n_total - 1)
        t, a = tag_s[pick], acc_s[pick]
        match = tags == t[:, None]
        hit = match.any(dim=1)
        score = torch.where(match, _IMAX, age)
        is_max = score == score.amax(dim=1, keepdim=True)
        touched = (is_max.cumsum(dim=1) == 1) & is_max & v[:, None]
        tags = torch.where(touched, t[:, None], tags)
        age = torch.where(v[:, None],
                          torch.where(touched, 0, age + a[:, None]), age)
        hit_s[torch.where(v, pos, n_total)] = hit & v
    hit_a = torch.empty(n_total, dtype=torch.bool, device=dev)
    hit_a[order] = hit_s[:n_total]

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

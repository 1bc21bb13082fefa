"""Set-associative LLC simulator — exact, lane-batched, runtime-configurable.

The FireSim LLC model is runtime-configurable in sets/ways/block size
without an FPGA rebuild; this is the same knob set, in PyTorch.  Two
execution paths, bit-identical in hit counts:

* **exact per-access scan** (``simulate_trace``): a Python loop, one
  true-LRU update per access — the reference semantics, used on
  unit-test traces as the parity oracle;
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
                      sets, ways, block_bytes, *, max_sets: int,
                      max_ways: int, r_pad: int, device=None) -> np.ndarray:
    """Exact segment replay of L lanes, each with its own geometry.

    ``bases/strides/counts`` are (L, S) or (1, S) int segment streams
    (count == 0 entries are padding and update nothing); ``sets/ways/
    block_bytes`` are (L,) geometries, padded in the state to
    ``max_sets``/``max_ways``.  ``r_needed`` ((L, S) or (S,)) and
    ``cold`` ((L, S) or (S,)) are the host-side execution plan
    (``repro_torch.core.sweep._lane_plan``): the round-scan rounds each
    segment needs (extra rounds are masked no-ops, missing rounds would
    be wrong) and whether its byte range is provably disjoint from
    everything replayed before it.

    Per segment the update is an exact decomposition:

    * a per-set round scan retires the first min(n_blocks, ways*sets)
      blocks (one block per set per round, all intra-block burst repeats
      folded into one LRU touch) in at most ``r_pad`` rounds — zero for
      a ``cold`` segment, whose arrivals provably all miss;
    * the rest of the segment finishes with a closed-form suffix: after
      `ways` arrivals in every set the cache provably holds exactly
      those arrivals, so every suffix block misses and victims cycle
      through the ways oldest-first.  The final occupants and their
      last-touch timestamps are written directly.

    LRU is tracked as a global last-touch timestamp (int32, as are the
    tags): recency order, and so every victim choice including
    first-index tie-breaks, is the per-set age order of
    ``simulate_trace``.  State is (L, max_ways, max_sets).  Everything
    that depends only on the trace and the geometry — block ranges,
    prefix/suffix split, suffix hits and the timestamp counter (a prefix
    sum of counts) — is planned on the host; the device runs the round
    scans and the suffix inserts, and the hit counts come back once, at
    the end.  Requires stride <= block_bytes and int32-range addresses
    (the caller checks).  Returns (L, S) int64 per-segment hit counts,
    bit-identical to expanding the trace and running the per-access
    scan at each lane's geometry.
    """
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

    # host plan, (L, S) each
    live = count > 0
    b_first = base // bb_h
    b_last = (base + (count - 1) * stride) // bb_h
    n_blocks = np.where(live, b_last - b_first + 1, 0)
    n_pre = np.where(cold, 0, np.minimum(n_blocks, ways_h * sets_h))
    sb_first = b_first + n_pre
    n_suf = np.maximum(n_blocks - n_pre, 0)
    has_suf = n_suf > 0
    lo = sb_first * bb_h - base
    first_suf = np.where(lo <= 0, 0, (lo + stride - 1) // stride)
    j_split = np.where(has_suf, first_suf, count)
    suf_hits = np.where(has_suf, (count - j_split) - n_suf, 0)
    live_count = np.where(live, count, 0)
    counter = np.cumsum(live_count, axis=1) - live_count

    def per_segment(a, what=None):
        """(L, S) host table -> (S, L, 1) device tensor: row j is
        segment j's per-lane column, a view."""
        a = np.array(a.T)[:, :, None]
        if what is not None:
            return as_address_tensor(a, device=dev, what=what)
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

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
    # [a, b]: way b precedes way a in a tie (stable oldest-first rank)
    earlier_way = (q_idx[None, :] < q_idx[:, None])[None, :, :, None]
    tags = torch.full((n_lane, max_ways, max_sets), -1, dtype=torch.int32,
                      device=dev)
    ts = torch.zeros_like(tags)

    hit_segs, hit_rows = [], []
    for j in range(shape[1]):
        if not live[:, j].any():
            continue
        base_j, stride_j, count_j = base_d[j], stride_d[j], count_d[j]
        counter_j = counter_d[j]
        if rounds[j] > 0:
            b_first_j, n_pre_j = b_first_d[j], n_pre_d[j]
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
                # unique per set), else the oldest real way; the cumsum
                # first-min mask is argmin's first-index tie-break
                key = torch.where(tags == t[:, None, :], -1,
                                  torch.where(way_mask, ts, _IMAX))
                kmin = key.amin(dim=1)
                hit = kmin == -1
                is_min = key == kmin[:, None, :]
                first_min = (is_min.cumsum(dim=1) == 1) & is_min
                touched = first_min & v[:, None, :]
                tags = torch.where(touched, t[:, None, :], tags)
                stamp = (counter_j + j_hi + 1).to(torch.int32)
                ts = torch.where(touched, stamp[:, None, :], ts)
                hits = hits + torch.where(v, j_hi - j_lo + hit, 0).sum(dim=1)
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

    out = suf_hits.astype(np.int64)
    if hit_rows:
        out[:, hit_segs] += torch.stack(hit_rows, dim=1).cpu().numpy()
    return out

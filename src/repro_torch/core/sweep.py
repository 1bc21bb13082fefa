"""Batched LLC sweeps: many cache geometries, one replay of the trace.

The segment-lane engine (``repro_torch.core.cache.segment_lane_scan``)
replays a *compressed* trace (``repro_torch.core.traces``) with a
leading lane dimension carrying one (sets, ways, block_bytes) geometry
per lane, state padded to the bucket's largest geometry.  Padded ways
and sets are masked out of both tag match and victim selection, so each
lane is bit-identical to the per-access simulator at its geometry.

Public API:
* ``segment_lane_hit_counts``  — (configs, segments) compressed-trace
                                 hit counts, shared or per-lane traces;
* ``segment_lane_hit_rates``   — the per-lane rates thereof;
* ``lane_buckets``             — lane indices grouped by set count;
* ``grid_configs``             — the Fig. 5 (size, block) geometries.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import traces
from repro_torch.core.cache import LLCConfig, _TouchedBlocks, segment_lane_scan
from repro_torch.utils.env import default_device

_segment_tuple = traces.segment_tuple


def _geometry_arrays(configs):
    sets = np.asarray([c.sets for c in configs], np.int64)
    ways = np.asarray([c.ways for c in configs], np.int64)
    blocks = np.asarray([c.block_bytes for c in configs], np.int64)
    return sets, ways, blocks, int(sets.max()), int(ways.max())


def _lane_plan(trace: list, configs: list[LLCConfig]
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side execution plan for one segment stream over a lane
    bucket: per segment, the round-scan rounds needed (max across the
    bucket's geometries — extra rounds in other lanes are masked no-ops)
    and whether the segment is provably cold (byte range disjoint, with
    block-alignment slack, from every earlier segment — all its arrivals
    miss in every lane, so the closed form needs no rounds at all)."""
    metas = [_segment_tuple(s) for s in trace]
    base = np.asarray([m[0] for m in metas], np.int64)
    stride = np.asarray([m[1] for m in metas], np.int64)
    count = np.asarray([m[2] for m in metas], np.int64)
    live = count > 0
    last = base + np.maximum(count - 1, 0) * stride
    slack = max(c.block_bytes for c in configs) - 1
    touched = _TouchedBlocks()
    cold = np.zeros(len(metas), bool)
    for j in range(len(metas)):
        if not live[j]:
            continue
        lo, hi = int(base[j] - slack), int(last[j] + slack)
        cold[j] = not touched.overlaps(lo, hi)
        touched.add(lo, hi)
    r = np.zeros(len(metas), np.int64)
    for c in configs:
        nb = last // c.block_bytes - base // c.block_bytes + 1
        r = np.maximum(r, np.minimum(c.ways, -(-nb // c.sets)))
    r = np.where(live & ~cold, r, 0)
    return r.astype(np.int32), cold


def _lane_meta_arrays(lanes: list[list]) -> tuple:
    """Per-lane segment streams -> (n_lane, max_segments) int64 metadata
    arrays, padded with count == 0 no-op segments."""
    n_seg = max((len(t) for t in lanes), default=0)
    shape = (len(lanes), max(1, n_seg))
    bases = np.zeros(shape, np.int64)
    strides = np.ones(shape, np.int64)
    counts = np.zeros(shape, np.int64)
    for i, trace in enumerate(lanes):
        for j, seg in enumerate(trace):
            bases[i, j], strides[i, j], counts[i, j] = _segment_tuple(seg)
    return bases, strides, counts


def _check_lane_support(lanes, configs) -> None:
    int32_max = np.iinfo(np.int32).max
    min_block = min(c.block_bytes for c in configs)
    for trace in lanes:
        total = 0
        for seg in trace:
            base, stride, count = _segment_tuple(seg)
            if count <= 0:
                continue
            total += count
            if stride <= 0 or stride > min_block:
                raise ValueError(
                    f"segment stride {stride} outside (0, {min_block}] — "
                    "the segment-lane engine needs stride <= block_bytes "
                    "in every lane")
            if base + count * stride > int32_max:
                raise OverflowError(
                    "segment addresses exceed int32 — the lane engine "
                    "keeps tags in 32-bit; rebase the trace")
        if total > int32_max:
            raise OverflowError(
                f"lane trace has {total} accesses — the lane engine's "
                "global LRU timestamp is int32; split multi-frame sweeps "
                "into per-frame lane calls")


def lane_buckets(configs: list[LLCConfig], waste: int = 2) -> list[list[int]]:
    """Partition lane indices into buckets of comparable set counts so a
    2-set lane doesn't pay a 4096-set lane's padding: lanes sorted by
    descending sets, a new bucket whenever a lane has fewer than
    1/`waste` of its bucket's maximum.  A homogeneous grid stays one
    bucket.  Deterministic for a given config list."""
    order = sorted(range(len(configs)), key=lambda i: -configs[i].sets)
    buckets: list[list[int]] = []
    bucket_max = None
    for i in order:
        if bucket_max is None or configs[i].sets * waste < bucket_max:
            buckets.append([])
            bucket_max = configs[i].sets
        buckets[-1].append(i)
    return buckets


def segment_lane_hit_counts(segments, configs: list[LLCConfig], *,
                            device=None) -> np.ndarray:
    """(n_cfg, n_segments) exact per-segment LLC hit counts of a
    compressed trace, one lane per geometry, replayed on ``device``
    (``cuda`` when None).

    ``segments`` is either one shared trace (list of ``Segment``/tuples,
    the Fig. 5 shape: one DBB stream, many geometries) or a list of
    per-lane traces (one geometry per lane, per-lane streams padded to
    the longest lane with count-0 no-op segments).  The trace is never
    expanded: serial depth is O(segments * max_ways), not O(accesses).
    Lanes with very different set counts are bucketed (``lane_buckets``)
    so padding waste stays bounded — a homogeneous grid is exactly one
    replay."""
    dev = default_device(device)
    per_lane = bool(segments) and isinstance(segments[0], list)
    lanes = segments if per_lane else [list(segments)] * len(configs)
    if per_lane and len(lanes) != len(configs):
        raise ValueError(f"{len(lanes)} lane traces for "
                         f"{len(configs)} configs")
    _check_lane_support(lanes, configs)
    n_seg = max((len(t) for t in lanes), default=0)
    out = np.zeros((len(configs), max(1, n_seg)), np.int64)
    for bucket in lane_buckets(configs):
        cfgs_b = [configs[i] for i in bucket]
        sets, ways, blocks, max_sets, max_ways = _geometry_arrays(cfgs_b)
        traces_b = [lanes[i] for i in bucket] if per_lane else lanes[:1]
        bases, strides, counts = _lane_meta_arrays(traces_b)
        r_needed = np.zeros(bases.shape, np.int32)
        cold = np.zeros(bases.shape, bool)
        for row, trace in enumerate(traces_b):
            r, c = _lane_plan(trace, cfgs_b)
            r_needed[row, :len(r)] = r
            cold[row, :len(c)] = c
        hits = segment_lane_scan(bases, strides, counts, r_needed, cold,
                                 sets, ways, blocks, max_sets=max_sets,
                                 max_ways=max_ways, r_pad=max_ways,
                                 device=dev)
        out[bucket, :hits.shape[1]] = hits
    return out


def segment_lane_hit_rates(segments, configs: list[LLCConfig], *,
                           device=None) -> np.ndarray:
    """(n_cfg,) exact hit rates — ``segment_lane_hit_counts`` over the
    per-lane access totals."""
    per_lane = bool(segments) and isinstance(segments[0], list)
    lanes = segments if per_lane else [list(segments)] * len(configs)
    hits = segment_lane_hit_counts(segments, configs,
                                   device=device).sum(axis=1)
    accesses = np.asarray(
        [max(1, sum(max(0, _segment_tuple(s)[2]) for s in t))
         for t in lanes], np.int64)
    return hits / accesses


def grid_configs(sizes_kib, blocks) -> dict[tuple, LLCConfig]:
    """The Fig. 5 grid's (size, block) -> LLCConfig mapping — delegates
    to ``repro_torch.core.soc.llc_config_for`` so the simulated and
    closed-form sweeps always describe the same geometry."""
    from repro_torch.core.soc import llc_config_for

    return {(size, block): llc_config_for(size, block)
            for block in blocks for size in sizes_kib}

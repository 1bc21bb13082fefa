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
* ``grid_configs``             — the Fig. 5 (size, block) geometries;
* ``MixConfig``                — a co-runner mix (count + working-set size);
* ``LaneMetrics``              — frozen typed record of one interference
                                 lane (``to_record``/``from_record``);
* ``SweepGrid``                — frozen typed result of the figure sweeps;
* ``interference_lane_metrics`` — one co-runner-interleaved lane through
                                 the exact segment engine and the
                                 closed-form DRAM row model ->
                                 ``LaneMetrics``, optionally LLC
                                 way-partitioned (``way_mask=``);
* ``interference_lane_metrics_batch`` — many lanes as lane-batched
                                 replays, one per set-count bucket,
                                 optionally per-lane way-partitioned
                                 (``way_masks=``) or sharded over a
                                 device mesh (``mesh=``);
* ``partition_way_sels``       — victim/co-runner allocation masks for an
                                 Intel-CAT-style two-class way partition;
* ``lane_request_latencies``   — per-victim-chunk memory latencies;
* ``step_lane_metrics``        — one scheduler step's DBB stream, cold or
                                 as the exact marginal cost after a warm
                                 prefix — the serving oracle's entry point;
* ``sweep_llc``                — Fig. 5 grid: closed-form speedups + exact
                                 segment-lane hit rates, windowed or full
                                 frame;
* ``sweep_interference``       — Fig. 6 grid: closed-form slowdowns + exact
                                 hit rates and closed-form DRAM row-hit
                                 rates under BwWrite co-runners.

The expanded-trace per-access lanes (``batched_hits`` /
``batched_hit_rates`` / ``batched_hits_per_trace``) and
``segment_sweep_hit_rates`` are deprecated or kept only as independent
per-access checks of the segment lanes across geometries: they
serialize on burst count (or replay one geometry at a time).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import traces
from repro_torch.core.cache import (
    LaneBatch,
    LLCConfig,
    _TouchedBlocks,
    cold_state,
    segment_lane_scan,
    segment_lane_scan_many,
    simulate_segments,
    walk_by_set,
)
from repro_torch.utils.env import as_address_tensor, default_device

_segment_tuple = traces.segment_tuple


# --------------------------------------------------------------------------
# typed lane results
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MixConfig:
    """A co-runner mix: how many BwWrite cores run beside the NVDLA and
    how large their working sets are ("l1" never reaches the shared
    fabric, "llc" occupies half the LLC, "dram" streams far past it —
    the three Fig. 6 regimes)."""
    corunners: int = 0
    wss: str = "l1"

    def __post_init__(self):
        if self.wss not in ("l1", "llc", "dram"):
            raise ValueError(f"unknown working-set size {self.wss!r} "
                             "(expected 'l1', 'llc' or 'dram')")
        if self.corunners < 0:
            raise ValueError("corunners must be >= 0")


@dataclasses.dataclass(frozen=True)
class LaneMetrics:
    """One interference lane's exact metric record — the typed currency
    between the sweep engine and the campaign executor (guardrails
    consume attributes, journals store ``to_record()`` dicts).

    Every field is a plain int/float: deterministic, JSON-stable, and
    internally consistent (``total_cycles`` satisfies the closed-form
    latency identity the executor re-checks)."""
    segments: int
    accesses: int
    llc_hits: int
    dram_row_hits: int
    t_llc_hit: int
    total_cycles: int
    hit_rate: float
    nvdla_accesses: int
    nvdla_hits: int
    nvdla_hit_rate: float
    nvdla_misses: int
    nvdla_miss_row_hits: int
    nvdla_miss_row_hit_rate: float

    _INT_FIELDS = ("segments", "accesses", "llc_hits", "dram_row_hits",
                   "t_llc_hit", "total_cycles", "nvdla_accesses",
                   "nvdla_hits", "nvdla_misses", "nvdla_miss_row_hits")
    _FLOAT_FIELDS = ("hit_rate", "nvdla_hit_rate",
                     "nvdla_miss_row_hit_rate")

    def to_record(self) -> dict:
        """Flat JSON-stable dict, keys == field names (the journaled
        point-record format of the reference's campaign manifests)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, record: dict) -> "LaneMetrics":
        """Rebuild from a journaled dict.  Raises ``KeyError`` on a
        missing field and ``TypeError``/``ValueError`` on a non-numeric
        one — the executor's replay validation relies on that."""
        kw = {f: int(record[f]) for f in cls._INT_FIELDS}
        kw.update({f: float(record[f]) for f in cls._FLOAT_FIELDS})
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """Typed result of a figure sweep (``sweep_llc`` /
    ``sweep_interference``): the closed-form curves plus the simulated
    per-point rates, with tuple-keyed dicts.  ``to_record()`` flattens
    tuple keys into JSON rows ([*key, value]); ``from_record`` restores
    them exactly."""
    kind: str                              # "llc" | "interference"
    sim_hit_rates: dict                    # (size,block) | (wss,n) -> rate
    window_bursts: int | None = None
    no_llc_s: float | None = None          # Fig. 5 baseline runtime
    speedups: dict | None = None           # (size_kib, block) -> speedup
    slowdowns: dict | None = None          # wss -> {n: slowdown}
    sim_row_hit_rates: dict | None = None  # (wss, n) -> DRAM row-hit rate

    def to_record(self) -> dict:
        rec: dict = {"kind": self.kind, "window_bursts": self.window_bursts,
                     "sim_hit_rates": [[*k, v] for k, v
                                       in self.sim_hit_rates.items()]}
        if self.no_llc_s is not None:
            rec["no_llc_s"] = self.no_llc_s
        if self.speedups is not None:
            rec["speedups"] = [[*k, v] for k, v in self.speedups.items()]
        if self.slowdowns is not None:
            rec["slowdowns"] = [[wss, n, v]
                                for wss, curve in self.slowdowns.items()
                                for n, v in curve.items()]
        if self.sim_row_hit_rates is not None:
            rec["sim_row_hit_rates"] = [[*k, v] for k, v
                                        in self.sim_row_hit_rates.items()]
        return rec

    @classmethod
    def from_record(cls, record: dict) -> "SweepGrid":
        def keyed(rows):
            return {tuple(r[:-1]): r[-1] for r in rows}

        slowdowns = None
        if "slowdowns" in record:
            slowdowns = {}
            for wss, n, v in record["slowdowns"]:
                slowdowns.setdefault(wss, {})[n] = v
        return cls(
            kind=record["kind"],
            window_bursts=record.get("window_bursts"),
            no_llc_s=record.get("no_llc_s"),
            sim_hit_rates=keyed(record["sim_hit_rates"]),
            speedups=(keyed(record["speedups"])
                      if "speedups" in record else None),
            slowdowns=slowdowns,
            sim_row_hit_rates=(keyed(record["sim_row_hit_rates"])
                               if "sim_row_hit_rates" in record else None))


def _simulate_padded(block_addrs, sets, ways, *, max_sets: int,
                     max_ways: int, device) -> torch.Tensor:
    """Exact per-access LLC scan of L lanes, each with its own geometry,
    on padded state: ``block_addrs`` (L, T) block addresses of each
    lane's trace, ``sets``/``ways`` (L,).  LRU is tracked as a
    last-touch timestamp (the recency *order*, and so every victim
    choice with its first-index tie-break, is the per-set age order);
    ways >= a lane's ``ways`` never match and never win victim
    selection.  One step per access: serial depth O(T).  Returns (L, T)
    bool hit bits.  This loop is the plain version; on ``cuda`` the
    lanes go through ``_padded_set_walks``, one ``llc_set_walk`` launch a
    way count."""
    block = torch.as_tensor(block_addrs, dtype=torch.int64, device=device)
    if _on_card(block):
        return _padded_set_walks(block, sets, ways)
    sets_d = torch.as_tensor(np.asarray(sets, np.int64), device=device)
    ways_d = torch.as_tensor(np.asarray(ways, np.int64), device=device)
    n_lane, n_acc = block.shape
    set_idx = torch.remainder(block, sets_d[:, None])
    tag = torch.div(block, sets_d[:, None], rounding_mode="floor").to(
        torch.int32)
    way_mask = torch.arange(max_ways, device=device)[None, :] < ways_d[:, None]
    lane = torch.arange(n_lane, device=device)
    tags = torch.full((n_lane, max_sets, max_ways), -1, dtype=torch.int32,
                      device=device)
    ts = torch.zeros_like(tags)
    hits = torch.zeros((n_lane, n_acc), dtype=torch.bool, device=device)
    imax = torch.iinfo(torch.int32).max
    for k in range(n_acc):
        s, t = set_idx[:, k], tag[:, k]
        row_tags, row_ts = tags[lane, s], ts[lane, s]           # (L, MW)
        match = (row_tags == t[:, None]) & way_mask
        hit = match.any(dim=1)
        victim = torch.where(way_mask, row_ts, imax)
        way = torch.where(hit, torch.argmax(match.to(torch.int8), dim=1),
                          torch.argmin(victim, dim=1))
        tags = tags.index_put((lane, s, way), t)
        ts = ts.index_put((lane, s, way),
                          torch.full_like(t, k + 1))
        hits[:, k] = hit
    return hits


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA device, where the per-access lanes
    take the kernel route."""
    return x.device.type == "cuda"


def _padded_set_walks(block: torch.Tensor, sets, ways) -> torch.Tensor:
    """``_simulate_padded``'s hit bits by one ``llc_set_walk`` launch a
    distinct way count.  A group's lanes become one geometry of their
    sets laid end to end (lane offsets the running sum of the lanes'
    sets); each lane's accesses keep their order within a set, every
    access count is 1 and the tags are the reference's int32.  The
    per-set age walk picks every victim the timestamp LRU picks (the
    recency order of the touched ways, the first index among the
    never-touched), so the hits are the padded loop's, bit for bit."""
    dev = block.device
    n_lane, n_acc = block.shape
    sets, ways = np.asarray(sets, np.int64), np.asarray(ways, np.int64)
    hits = torch.zeros((n_lane, n_acc), dtype=torch.bool, device=dev)
    if n_acc == 0:
        return hits
    # widest group first
    for w in np.unique(ways)[::-1]:
        lanes = np.nonzero(ways == w)[0]
        lane_sets = sets[lanes]
        sets_d = torch.as_tensor(lane_sets, device=dev)[:, None]
        offset = torch.as_tensor(np.cumsum(lane_sets) - lane_sets,
                                 device=dev)[:, None]
        blk = block[torch.as_tensor(lanes, device=dev)]
        fused = (torch.remainder(blk, sets_d) + offset).flatten()
        tag = torch.div(blk, sets_d, rounding_mode="floor").to(
            torch.int32).flatten()
        hit, _, _ = walk_by_set(*cold_state(int(lane_sets.sum()), int(w),
                                            device=dev),
                                fused, tag, torch.ones_like(tag))
        hits[torch.as_tensor(lanes, device=dev)] = hit.view(len(lanes), n_acc)
    return hits


_EXPANDED_TRACE_DEPRECATION = (
    "the expanded-trace per-access lanes are deprecated: serial depth is "
    "O(accesses) per lane.  Use the segment-lane API "
    "(segment_lane_hit_counts / segment_lane_hit_rates / "
    "interference_lane_metrics_batch) which replays the compressed trace "
    "directly.")


def _expanded_lanes(byte_addrs_2d, configs, device) -> torch.Tensor:
    dev = default_device(device)
    addrs = as_address_tensor(byte_addrs_2d, device=dev, what="DBB trace")
    sets, ways, blocks, max_sets, max_ways = _geometry_arrays(configs)
    bb = torch.as_tensor(blocks, device=dev)[:, None]
    return _simulate_padded(torch.div(addrs, bb, rounding_mode="floor"),
                            sets, ways, max_sets=max_sets,
                            max_ways=max_ways, device=dev)


def batched_hits(byte_addrs, configs: list[LLCConfig], *,
                 device=None) -> np.ndarray:
    """(n_cfg, T) per-access hit bits of one byte trace — every lane
    bit-identical to the unbatched ``simulate_trace`` at that geometry,
    replayed on ``device`` (``cuda`` when None).  On ``cuda`` the lanes
    walk by ``llc_set_walk`` at any way count, with no plain fallback;
    the CPU runs the padded per-access loop.

    .. deprecated:: kept only as a parity oracle for the segment-lane
       engine; use ``segment_lane_hit_counts``."""
    warnings.warn(_EXPANDED_TRACE_DEPRECATION, DeprecationWarning,
                  stacklevel=2)
    addrs = np.asarray(byte_addrs, np.int64)[None, :]
    return _expanded_lanes(np.repeat(addrs, len(configs), axis=0), configs,
                           device).cpu().numpy()


def batched_hit_rates(byte_addrs, configs: list[LLCConfig], *,
                      device=None) -> np.ndarray:
    """(n_cfg,) float32 hit rates of ``batched_hits``' lanes, as the
    reference's mean computes them: each lane's hit count times the
    float32 reciprocal of T.  On ``cuda`` by ``llc_set_walk``, as
    ``batched_hits``."""
    warnings.warn(_EXPANDED_TRACE_DEPRECATION, DeprecationWarning,
                  stacklevel=2)
    addrs = np.asarray(byte_addrs, np.int64)[None, :]
    hits = _expanded_lanes(np.repeat(addrs, len(configs), axis=0), configs,
                           device).sum(dim=1).cpu().numpy()
    return hits.astype(np.float32) * (np.float32(1)
                                      / np.float32(addrs.shape[1]))


def batched_hits_per_trace(byte_addrs_2d, configs: list[LLCConfig], *,
                           device=None) -> np.ndarray:
    """Like ``batched_hits`` but with one trace per lane (n_cfg, T);
    on ``cuda`` by ``llc_set_walk``, as ``batched_hits``.

    .. deprecated:: the interference sweep feeds compressed co-runner
       lanes to the segment engine (``interference_lane_metrics_batch``)."""
    warnings.warn(_EXPANDED_TRACE_DEPRECATION, DeprecationWarning,
                  stacklevel=2)
    return _expanded_lanes(byte_addrs_2d, configs, device).cpu().numpy()


def segment_sweep_hit_rates(segments, configs: list[LLCConfig], *,
                            device=None) -> np.ndarray:
    """(n_cfg,) exact hit rates of one *compressed* trace — each config
    replayed through the single-geometry segment engine
    (``cache.simulate_segments``) on ``device``: an independent check of
    the lane engine, exactly ``hit_rate`` of the expanded trace."""
    return np.asarray([simulate_segments(segments, c, device=device).hit_rate
                       for c in configs], np.float64)


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
    """The lane engine's support over lists of segments: every lane
    through ``_check_lane_support_meta``."""
    _check_lane_support_meta(
        [tuple(np.asarray(a, np.int64).reshape(-1) for a in
               zip(*map(_segment_tuple, trace))) if trace
         else (np.zeros(0, np.int64),) * 3 for trace in lanes], configs)


def _check_lane_support_meta(lanes_meta, configs) -> None:
    """`_check_lane_support` over (bases, strides, counts) array lanes —
    the same constraints, vectorized."""
    int32_max = np.iinfo(np.int32).max
    min_block = min(c.block_bytes for c in configs)
    for base, stride, count in lanes_meta:
        live = count > 0
        bad = live & ((stride <= 0) | (stride > min_block))
        if np.any(bad):
            raise ValueError(
                f"segment stride {int(stride[bad][0])} outside "
                f"(0, {min_block}] — the segment-lane engine needs "
                "stride <= block_bytes in every lane; use "
                "segment_sweep_hit_rates for sparse-stride traces")
        if np.any(live & (base + count * stride > int32_max)):
            raise OverflowError(
                "segment addresses exceed int32 — the lane engine "
                "keeps tags in 32-bit; rebase the trace")
        if int(count[live].sum()) > int32_max:
            raise OverflowError(
                f"lane trace has {int(count[live].sum())} accesses — "
                "the lane engine's global LRU timestamp is int32; split "
                "multi-frame sweeps into per-frame lane calls")


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
    so padding waste stays bounded, and every bucket replays in one call
    of ``segment_lane_scan_many`` (one kernel launch on the card)."""
    dev = default_device(device)
    per_lane = bool(segments) and isinstance(segments[0], list)
    lanes = segments if per_lane else [list(segments)] * len(configs)
    if per_lane and len(lanes) != len(configs):
        raise ValueError(f"{len(lanes)} lane traces for "
                         f"{len(configs)} configs")
    _check_lane_support(lanes, configs)
    n_seg = max((len(t) for t in lanes), default=0)
    out = np.zeros((len(configs), max(1, n_seg)), np.int64)
    buckets = lane_buckets(configs)
    batches = []
    for bucket in buckets:
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
        batches.append(LaneBatch(bases, strides, counts, r_needed, cold,
                                 sets, ways, blocks, max_sets=max_sets,
                                 max_ways=max_ways, r_pad=max_ways))
    # every bucket in one replay: the buckets' chains run side by side
    for bucket, hits in zip(buckets, segment_lane_scan_many(batches,
                                                            device=dev)):
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


def sweep_llc(sizes_kib=(0.5, 2, 8, 64, 512, 1024, 4096),
              blocks=(32, 64, 128), *, soc=None,
              window_bursts: int | None = 4096, device=None) -> SweepGrid:
    """Fig. 5, batched: the closed-form timing grid (``.speedups``,
    ``.no_llc_s``) plus exact simulated hit rates for every geometry
    (``.sim_hit_rates``) from the lane-batched segment engine on
    ``device`` (``cuda`` when None), as a typed ``SweepGrid``.

    ``window_bursts=None`` simulates the *entire* YOLOv3 frame (at
    stream granularity — the whole-network compressed trace); an integer
    clips to an arbiter-interleaved window of a representative layer.
    Either way the trace stays compressed end to end: serial depth
    scales with segment count, not burst count."""
    from repro_torch.core.soc import SoCConfig, llc_sweep as _closed_form

    soc = soc or SoCConfig()
    cf = _closed_form(sizes_kib=sizes_kib, blocks=blocks, soc=soc)
    cfgs = grid_configs(sizes_kib, blocks)
    if window_bursts is None:
        win = traces.network_trace()
    else:
        win = traces.default_dbb_window(max_bursts=window_bursts)
    rates = segment_lane_hit_rates(win, list(cfgs.values()), device=device)
    return SweepGrid(
        kind="llc",
        no_llc_s=cf["no_llc_s"],
        speedups=cf["grid"],
        sim_hit_rates={key: float(r) for key, r in zip(cfgs, rates)},
        window_bursts=traces.total_bursts(win))


# --------------------------------------------------------------------------
# interference lanes (Fig. 6) and serving steps
# --------------------------------------------------------------------------
def corunner_segments(nvdla_segs: list, *, llc: LLCConfig,
                      mix: MixConfig, chunk_bursts: int = 16
                      ) -> tuple[list, np.ndarray]:
    """One lane's interleaved trace, *compressed*: a `chunk_bursts`-burst
    NVDLA chunk, then `chunk_bursts` 64 B write lines from each of the
    mix's `corunners` BwWrite cores, round-robin — the DBB/front-bus
    arbiter at chunk granularity.  Returns (segments,
    nvdla_label_mask); each co-runner's stream stays a valid stride run
    (wraps in its working-set span split at the wrap point).  Working
    sets: "llc" wraps inside half the LLC (occupies it), "dram" streams
    far past it (sweeps it), "l1" never reaches the shared fabric (no
    co-runner accesses)."""
    n = 0 if mix.wss == "l1" else mix.corunners
    chunks = [c for s in nvdla_segs for c in s.split(chunk_bursts)]
    spans_regions = _corunner_spans(llc, mix)
    cursors = [0] * n
    segs: list[traces.Segment] = []
    labels: list[bool] = []
    for chunk in chunks:
        segs.append(chunk)
        labels.append(True)
        for w in range(n):
            left = chunk.count
            span_lines, region = spans_regions[w]
            while left > 0:                   # split at working-set wrap
                start = cursors[w] % span_lines
                take = min(left, span_lines - start)
                segs.append(traces.Segment(region + start * 64, 64, take,
                                           f"bw{w}"))
                labels.append(False)
                cursors[w] += take
                left -= take
    return segs, np.asarray(labels)


def _corunner_spans(llc: LLCConfig, mix: MixConfig) -> list[tuple[int, int]]:
    """Each co-runner's (span_lines, region_base) — the one definition
    ``corunner_segments`` and ``corunner_meta`` share."""
    n = 0 if mix.wss == "l1" else mix.corunners
    spans_regions = []
    for w in range(n):
        if mix.wss == "llc":
            span = max(64, llc.size_bytes // 2)
            region = 0x4000_0000 + w * 0x0100_0000
        else:                                             # "dram"
            span = llc.size_bytes * 8
            region = 0x6000_0000 + w * 0x0800_0000
        # stagger start banks (2 KiB row offsets) like the NVDLA regions
        # in repro_torch.core.traces — co-runners don't all start on bank 0
        region += (5 + 7 * w) * 2048
        spans_regions.append((span // 64, region))
    return spans_regions


def nvdla_chunks(nvdla_segs: list, chunk_bursts: int = 16) -> tuple:
    """The chunked NVDLA stream as ``(bases, strides, counts)`` int64
    arrays — ``Segment.split(chunk_bursts)`` over the whole window,
    array-native.  Depends only on the trace, not the lane's geometry
    or mix, so batched callers compute it once and pass it to every
    ``corunner_meta`` call (``_chunks``)."""
    cb, cs, cc = [], [], []
    for s in nvdla_segs:
        base, stride, count = _segment_tuple(s)
        if count <= 0:
            continue
        n_ch = -(-count // chunk_bursts)
        idx = np.arange(n_ch, dtype=np.int64)
        cb.append(base + idx * (chunk_bursts * stride))
        cs.append(np.full(n_ch, stride, np.int64))
        cnt = np.full(n_ch, chunk_bursts, np.int64)
        cnt[-1] = count - (n_ch - 1) * chunk_bursts
        cc.append(cnt)
    if not cb:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    return tuple(np.concatenate(a) for a in (cb, cs, cc))


def corunner_meta(nvdla_segs: list, *, llc: LLCConfig, mix: MixConfig,
                  chunk_bursts: int = 16, _chunks: tuple | None = None
                  ) -> tuple:
    """Array-native twin of ``corunner_segments``: the same interleaved
    lane trace as ``(bases, strides, counts, nvdla_mask)`` int64/bool
    numpy arrays — segment for segment identical to
    ``[segment_tuple(s) for s in corunner_segments(...)[0]]`` — built
    with no per-segment Python objects.  ``_chunks`` takes a precomputed
    ``nvdla_chunks`` result (lane-invariant, so batch callers share
    one).  Falls back to materializing ``corunner_segments`` when a
    co-runner chunk wraps its working set more than once (spans smaller
    than a chunk)."""
    n, wss = mix.corunners, mix.wss
    if wss == "l1":
        n = 0
    cb, cs, cc = (_chunks if _chunks is not None
                  else nvdla_chunks(nvdla_segs, chunk_bursts))
    if cb.shape[0] == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy(), np.zeros(0, bool)
    n_ch = cb.shape[0]
    if n == 0:
        return cb, cs, cc, np.ones(n_ch, bool)
    pre = np.concatenate([[0], np.cumsum(cc)[:-1]])   # cursor before chunk
    chunk_i = np.arange(n_ch, dtype=np.int64)
    parts = [(cb, cs, cc, chunk_i, np.zeros(n_ch, np.int64), True)]
    for w, (span_lines, region) in enumerate(_corunner_spans(llc, mix)):
        start = pre % span_lines
        take1 = np.minimum(cc, span_lines - start)
        rest = cc - take1
        if np.any(rest > span_lines):     # >2 wraps: rare tiny spans
            segs, nv = corunner_segments(nvdla_segs, llc=llc, mix=mix,
                                         chunk_bursts=chunk_bursts)
            m = np.asarray([_segment_tuple(sg) for sg in segs],
                           np.int64).reshape(-1, 3)
            return m[:, 0], m[:, 1], m[:, 2], np.asarray(nv, bool)
        s64 = np.full(n_ch, 64, np.int64)
        parts.append((region + start * 64, s64, take1, chunk_i,
                      np.full(n_ch, 1 + 2 * w, np.int64), False))
        j2 = np.flatnonzero(rest > 0)
        if j2.size:
            parts.append((np.full(j2.size, region, np.int64),
                          np.full(j2.size, 64, np.int64), rest[j2], j2,
                          np.full(j2.size, 2 + 2 * w, np.int64), False))
    bases = np.concatenate([p[0] for p in parts])
    strides = np.concatenate([p[1] for p in parts])
    counts = np.concatenate([p[2] for p in parts])
    chunks = np.concatenate([p[3] for p in parts])
    slots = np.concatenate([p[4] for p in parts])
    nv = np.concatenate([np.full(p[0].shape[0], p[5], bool)
                         for p in parts])
    order = np.lexsort((slots, chunks))   # chunk-major, arbiter slots
    return bases[order], strides[order], counts[order], nv[order]


def _lane_metrics_from_runs(*, n_segments, accesses, hits, runs, bb, nv,
                            dram, t_llc_hit, nv_acc, nv_hits) -> LaneMetrics:
    """The shared lane reduction: exact LLC counts + miss runs
    ((first_block, n_blocks, seg_idx) triples in access order, either a
    list of tuples or a tuple of three aligned int64 arrays) ->
    closed-form DRAM row hits -> closed-form latency total -> the typed
    record.  Both the sequential and the batched path end here, so
    their metrics are bit-identical by construction."""
    from repro_torch.core.dram import segment_row_hits

    if isinstance(runs, tuple):
        fb, nbk, sidx = (np.asarray(a, np.int64) for a in runs)
    else:
        arr = np.asarray(runs, np.int64).reshape(-1, 3)
        fb, nbk, sidx = arr[:, 0], arr[:, 1], arr[:, 2]
    row = segment_row_hits((fb * bb, np.full(fb.shape[0], bb, np.int64),
                            nbk), dram)
    run_is_nv = np.asarray(nv, bool)[sidx]
    nv_miss = int(nbk[run_is_nv].sum())
    nv_row_hits = int(row.per_segment[run_is_nv].sum())
    misses = accesses - hits
    row_misses = misses - row.row_hits
    total = (accesses * t_llc_hit + misses * dram.t_cas_cycles
             + row_misses * (dram.t_rp_cycles + dram.t_rcd_cycles))
    return LaneMetrics(
        segments=n_segments,
        accesses=int(accesses),
        llc_hits=int(hits),
        dram_row_hits=int(row.row_hits),
        t_llc_hit=int(t_llc_hit),
        total_cycles=int(total),
        hit_rate=hits / max(1, accesses),
        nvdla_accesses=nv_acc,
        nvdla_hits=nv_hits,
        nvdla_hit_rate=nv_hits / max(1, nv_acc),
        nvdla_misses=nv_miss,
        nvdla_miss_row_hits=nv_row_hits,
        nvdla_miss_row_hit_rate=(nv_row_hits / nv_miss
                                 if nv_miss else 1.0))


def _check_row_block(llc: LLCConfig, dram) -> None:
    if dram.row_bytes % llc.block_bytes:
        raise ValueError("row_bytes must be a multiple of block_bytes "
                         "for the segment-native interference lane")


def partition_way_sels(nv_mask, llc: LLCConfig, way_mask: int) -> np.ndarray:
    """Per-segment allocation masks for an LLC way partition: the
    victim (NVDLA) segments allocate only into ``way_mask``'s ways,
    co-runner segments into the complement — Intel-CAT-style two-class
    partitioning.  ``way_mask == (1 << ways) - 1`` (the full mask)
    means *no* partition: both classes allocate anywhere, bit-exactly
    the unpartitioned scan.

    Raises ``ValueError`` when the victim mask selects no real way —
    an empty partition cannot allocate."""
    full = (1 << llc.ways) - 1
    vm = int(way_mask) & full
    if vm == 0:
        raise ValueError(
            f"way_mask {way_mask:#x} selects none of the {llc.ways} "
            "ways — the victim partition must hold at least one way")
    co = full & ~vm
    if co == 0:
        co = full        # full victim mask == unpartitioned for everyone
    return np.where(np.asarray(nv_mask, bool), vm, co).astype(np.int32)


def _masked_lane_run(b, s, c, llc: LLCConfig, way_sels,
                     *, return_state: bool = False, device=None):
    """One way-partitioned lane through the masked segment engine on
    ``device``: every segment carries a non-zero allocation mask, so the
    plan gives every segment its full ``ceil(n_blocks / sets)`` rounds
    (no closed-form suffix — the suffix assumes unrestricted victim
    cycling) and miss runs are reconstructed with ``full_prefix=True``.
    Returns (per_segment_hits, miss_run_arrays[, final_state]) with the
    state as (ways, sets) int32 arrays."""
    bb, sets, ways = llc.block_bytes, llc.sets, llc.ways
    live = c > 0
    last = b + np.maximum(c - 1, 0) * s
    nb = np.where(live, last // bb - b // bb + 1, 0)
    r_needed = -(-nb // sets)
    r_pad = max(1, int(r_needed.max(initial=1)))
    cold = np.zeros(b.shape[0], bool)
    out = segment_lane_scan(b[None], s[None], c[None], r_needed, cold,
                            [sets], [ways], [bb], np.asarray(way_sels),
                            max_sets=sets, max_ways=ways, r_pad=r_pad,
                            collect=True, suffix="none",
                            return_state=return_state, device=device)
    hits = out[0][0]
    runs = _lane_miss_runs(b, s, c, llc, cold, out[1][0], full_prefix=True)
    if return_state:
        return hits, runs, tuple(a[0] for a in out[2])
    return hits, runs


def interference_lane_metrics(nvdla_segs: list, *, llc: LLCConfig,
                              dram, mix: MixConfig,
                              chunk_bursts: int = 16,
                              t_llc_hit: int = 20,
                              way_mask: int | None = None,
                              device=None) -> LaneMetrics:
    """One interference lane, simulated exactly and reduced to the typed
    ``LaneMetrics`` record: the co-runner-interleaved compressed trace
    goes once through the exact segment LLC engine on ``device``
    (``cuda`` when None; per-segment hit attribution + exact miss runs),
    the miss runs through the closed-form DRAM row model, and the
    latency total through the closed-form identity — so every field is
    deterministic and internally consistent.

    ``mix.corunners=0`` (or ``mix.wss="l1"``) is the solo-NVDLA lane.

    ``way_mask`` turns on LLC way partitioning (``partition_way_sels``):
    victim segments allocate only into ``way_mask``'s ways, co-runners
    into the complement.  The full mask is bit-exactly the
    unpartitioned lane."""
    bb = llc.block_bytes
    _check_row_block(llc, dram)
    if way_mask is not None:
        b, s, c, nv = corunner_meta(nvdla_segs, llc=llc, mix=mix,
                                    chunk_bursts=chunk_bursts)
        _check_lane_support_meta([(b, s, c)], [llc])
        way_sels = partition_way_sels(nv, llc, way_mask)
        hits, runs = _masked_lane_run(b, s, c, llc, way_sels, device=device)
        n_seg = c.shape[0]
        accesses = int(c.sum())
        lane_hits = int(hits[:n_seg].sum())
        if int(runs[1].sum()) != accesses - lane_hits:
            raise RuntimeError(
                "masked lane miss-run reconstruction disagrees with the "
                f"engine: {int(runs[1].sum())} missed blocks vs "
                f"{accesses - lane_hits} misses")
        return _lane_metrics_from_runs(
            n_segments=n_seg, accesses=accesses, hits=lane_hits,
            runs=runs, bb=bb, nv=nv, dram=dram, t_llc_hit=t_llc_hit,
            nv_acc=int(c[nv].sum()),
            nv_hits=int(hits[:n_seg][nv].sum()))
    segs, nv = corunner_segments(nvdla_segs, llc=llc, mix=mix,
                                 chunk_bursts=chunk_bursts)
    res = simulate_segments(segs, llc, per_segment=True,
                            collect_miss_runs=True, device=device)
    counts = np.asarray([s.count for s in segs], np.int64)
    return _lane_metrics_from_runs(
        n_segments=len(segs), accesses=int(res.accesses),
        hits=int(res.hits), runs=res.miss_runs, bb=bb,
        nv=nv, dram=dram, t_llc_hit=t_llc_hit,
        nv_acc=int(counts[nv].sum()),
        nv_hits=int(res.per_segment_hits[nv].sum()))


def lane_request_latencies(nvdla_segs: list, *, llc: LLCConfig, dram,
                           mix: MixConfig, chunk_bursts: int = 16,
                           t_llc_hit: int = 20,
                           way_mask: int | None = None, device=None
                           ) -> tuple[np.ndarray, LaneMetrics]:
    """Per-victim-chunk memory latencies of one interference lane — the
    memory half of a farm's tail-latency distribution — replayed on
    ``device`` (``cuda`` when None).

    The lane's closed-form latency identity is linear in per-segment
    counters (``accesses * t_llc_hit + misses * tCAS + row_misses *
    (tRP + tRCD)``), so it distributes exactly over segments: each
    segment's share uses its own access/hit counts plus its row hits
    (attributed from the lane's miss runs).  ``corunner_segments``
    emits exactly one victim segment per ``chunk_bursts``-burst chunk,
    so the victim rows *are* the per-chunk service latencies — returned
    in stream order alongside the lane's ``LaneMetrics``.  The
    per-segment latencies provably sum to ``metrics.total_cycles`` (the
    identity's linearity; asserted here).

    ``way_mask`` partitions the LLC as in
    ``interference_lane_metrics``."""
    from repro_torch.core.dram import segment_row_hits

    bb = llc.block_bytes
    _check_row_block(llc, dram)
    if way_mask is not None:
        b, s, c, nv = corunner_meta(nvdla_segs, llc=llc, mix=mix,
                                    chunk_bursts=chunk_bursts)
        _check_lane_support_meta([(b, s, c)], [llc])
        way_sels = partition_way_sels(nv, llc, way_mask)
        hits, runs = _masked_lane_run(b, s, c, llc, way_sels, device=device)
        counts = np.asarray(c, np.int64)
        hits = np.asarray(hits[:counts.shape[0]], np.int64)
    else:
        segs, nv = corunner_segments(nvdla_segs, llc=llc, mix=mix,
                                     chunk_bursts=chunk_bursts)
        res = simulate_segments(segs, llc, per_segment=True,
                                collect_miss_runs=True, device=device)
        counts = np.asarray([sg.count for sg in segs], np.int64)
        hits = np.asarray(res.per_segment_hits, np.int64)
        runs = res.miss_runs
    if isinstance(runs, tuple):
        fb, nbk, sidx = (np.asarray(a, np.int64) for a in runs)
    else:
        arr = np.asarray(runs, np.int64).reshape(-1, 3)
        fb, nbk, sidx = arr[:, 0], arr[:, 1], arr[:, 2]
    row = segment_row_hits((fb * bb, np.full(fb.shape[0], bb, np.int64),
                            nbk), dram)
    seg_row = np.zeros(counts.shape[0], np.int64)
    np.add.at(seg_row, sidx, np.asarray(row.per_segment, np.int64))
    misses = counts - hits
    per_seg = (counts * t_llc_hit + misses * dram.t_cas_cycles
               + (misses - seg_row) * (dram.t_rp_cycles
                                       + dram.t_rcd_cycles))
    metrics = _lane_metrics_from_runs(
        n_segments=counts.shape[0], accesses=int(counts.sum()),
        hits=int(hits.sum()), runs=(fb, nbk, sidx), bb=bb, nv=nv,
        dram=dram, t_llc_hit=t_llc_hit, nv_acc=int(counts[nv].sum()),
        nv_hits=int(hits[nv].sum()))
    if int(per_seg.sum()) != metrics.total_cycles:
        raise RuntimeError(
            "per-segment latency attribution does not sum to the lane "
            f"total: {int(per_seg.sum())} vs {metrics.total_cycles}")
    return per_seg[np.asarray(nv, bool)], metrics

def _marginal_lane_metrics(full: LaneMetrics, warm: LaneMetrics
                           ) -> LaneMetrics:
    """Counter-wise difference of two lane records (full − warm), with
    the derived rates recomputed from the differenced counters.  Exact
    whenever ``warm``'s trace is a prefix of ``full``'s: the LLC engine
    and the DRAM open-row carry are both left-to-right, so the prefix's
    counters are unchanged by what follows and subtraction isolates the
    suffix — including the closed-form latency identity, which is linear
    in the counters."""
    d = {f: getattr(full, f) - getattr(warm, f)
         for f in LaneMetrics._INT_FIELDS if f != "t_llc_hit"}
    if full.t_llc_hit != warm.t_llc_hit:
        raise ValueError("marginal lane metrics need matching t_llc_hit")
    nv_miss = d["nvdla_misses"]
    return LaneMetrics(
        t_llc_hit=full.t_llc_hit,
        hit_rate=d["llc_hits"] / max(1, d["accesses"]),
        nvdla_hit_rate=d["nvdla_hits"] / max(1, d["nvdla_accesses"]),
        nvdla_miss_row_hit_rate=(d["nvdla_miss_row_hits"] / nv_miss
                                 if nv_miss else 1.0),
        **d)


def step_lane_metrics(segments: list, *, llc: LLCConfig, dram,
                      mix: MixConfig | None = None,
                      warm_prefix: list | None = None,
                      chunk_bursts: int = 16,
                      t_llc_hit: int = 20, device=None) -> LaneMetrics:
    """One scheduler step's DBB stream reduced to a typed lane record —
    the reusable step-latency entry point behind ``repro_torch.serve``.

    Without ``warm_prefix`` this is a cold-cache
    ``interference_lane_metrics`` lane.  With it, the step is simulated
    *after* the prefix (LLC state and DRAM open rows warmed by it, the
    co-runner interleave continuing causally across the boundary) and
    the returned record is the exact marginal cost of the step:
    ``sim(prefix + step) − sim(prefix)``.  Passing the step trace itself
    as its own warm prefix yields the steady-state per-step cost of a
    periodic working set — which is how a serving engine's decode step
    sees occupancy-dependent LLC contention (the Fig. 6 effect): working
    sets that fit the LLC re-hit across steps, and each admitted
    co-resident sequence grows the cyclic re-reference distance until
    the shared cache stops covering it.

    The subtraction is exact, not approximate: ``corunner_segments``
    chunks per segment so the prefix's interleaved trace is a prefix of
    the combined interleaved trace, and every counter (LLC hits, DRAM
    row hits, the latency total) is a left-to-right fold over that
    trace (the reference's tests assert the identity against an
    explicitly warmed replay)."""
    mix = mix or MixConfig()
    if warm_prefix is None:
        return interference_lane_metrics(
            segments, llc=llc, dram=dram, mix=mix,
            chunk_bursts=chunk_bursts, t_llc_hit=t_llc_hit,
            device=device)
    full = interference_lane_metrics(
        list(warm_prefix) + list(segments), llc=llc, dram=dram, mix=mix,
        chunk_bursts=chunk_bursts, t_llc_hit=t_llc_hit, device=device)
    warm = interference_lane_metrics(
        list(warm_prefix), llc=llc, dram=dram, mix=mix,
        chunk_bursts=chunk_bursts, t_llc_hit=t_llc_hit, device=device)
    return _marginal_lane_metrics(full, warm)


def _lane_miss_runs(base, stride, count, llc: LLCConfig, cold: np.ndarray,
                    miss_bits: np.ndarray, *,
                    full_prefix: bool = False) -> tuple:
    """Reconstruct one lane's exact missed-block runs from the lane
    engine's round-scan miss bits plus the analytically-known suffix
    (every block past the round-scanned prefix misses; a cold segment
    is all suffix).  Runs come out in segment order with blocks
    ascending within a segment — the same access order
    ``simulate_segments(collect_miss_runs=True)`` emits, up to
    adjacent-run splits *within* a segment, which the closed-form row
    model is invariant to (identical expanded access sequence).

    ``base/stride/count`` are the lane's (n_segments,) metadata arrays;
    returns ``(first_blocks, n_blocks, seg_idx)`` int64 arrays, fully
    vectorized — no per-segment interpreter work.

    ``full_prefix`` matches a way-masked lane's plan: every segment
    retired entirely in the round scan (the engine forces
    n_pre == n_blocks for mask != 0 segments), so there is no analytic
    suffix and every miss is a collected bit."""
    bb, sets, ways = llc.block_bytes, llc.sets, llc.ways
    n_seg = base.shape[0]
    live = count > 0
    b_first = base // bb
    b_last = (base + np.maximum(count - 1, 0) * stride) // bb
    nb = np.where(live, b_last - b_first + 1, 0)
    if full_prefix:
        n_pre = nb
    else:
        n_pre = np.where(np.asarray(cold[:n_seg], bool), 0,
                         np.minimum(nb, ways * sets))
    sj, kj, cj = np.nonzero(miss_bits[:n_seg])
    ordv = ((cj.astype(np.int64) - b_first[sj]) % sets
            + kj.astype(np.int64) * sets)
    order = np.lexsort((ordv, sj))
    sj, ordv = sj[order].astype(np.int64), ordv[order]
    first = np.ones(sj.shape[0], bool)
    if sj.shape[0]:
        first[1:] = (sj[1:] != sj[:-1]) | (ordv[1:] != ordv[:-1] + 1)
    pos = np.flatnonzero(first)
    run_seg = sj[pos]
    run_ord = ordv[pos]
    run_len = np.diff(np.append(pos, sj.shape[0]))
    # the analytic suffix is one contiguous run [n_pre, nb) per segment,
    # merged into the last round-scan run when it abuts it
    suf_seg = np.flatnonzero(live & (nb > n_pre))
    suf_len = (nb - n_pre)[suf_seg]
    at = np.searchsorted(run_seg, suf_seg, side="right") - 1
    has_pre = (at >= 0) & (run_seg[np.maximum(at, 0)] == suf_seg)
    at_m = at[has_pre]
    merge = np.zeros(suf_seg.shape[0], bool)
    merge[has_pre] = (run_ord[at_m] + run_len[at_m]) == n_pre[suf_seg[has_pre]]
    run_len[at[merge]] += suf_len[merge]
    run_seg = np.concatenate([run_seg, suf_seg[~merge]])
    run_ord = np.concatenate([run_ord, n_pre[suf_seg[~merge]]])
    run_len = np.concatenate([run_len, suf_len[~merge]])
    order = np.lexsort((run_ord, run_seg))
    run_seg, run_ord, run_len = (a[order] for a in
                                 (run_seg, run_ord, run_len))
    return b_first[run_seg] + run_ord, run_len.astype(np.int64), run_seg


def _mesh_lane_metrics(nvdla_segs: list, *, llcs, drams, mixes,
                       chunk_bursts: int, t_llc_hit: int,
                       mesh) -> list[LaneMetrics]:
    """``interference_lane_metrics_batch`` over a ``SweepMesh``: lane
    slice ``d`` (contiguous; the first ``lanes % n_dev`` slices one lane
    longer) replays on ``mesh.devices[d]``.  No lane is padded: every
    lane's result is independent of its batchmates, so the slices need
    not be equal.  Every future's result is read, so a slice's error
    propagates.  A pool thread starts with device 0 current, so each
    makes its slice's CUDA device current (the kernels' launch guard,
    ``kernels._build.launch_stream``, does so again at each launch)."""
    n_dev = len(mesh.devices)
    per, extra = divmod(len(llcs), n_dev)
    bounds, lo = [], 0
    for d in range(n_dev):
        hi = lo + per + (d < extra)
        if hi > lo:
            bounds.append((mesh.devices[d], lo, hi))
        lo = hi

    def run(dev, lo, hi):
        with torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext():
            return interference_lane_metrics_batch(
                nvdla_segs, llcs=llcs[lo:hi], drams=drams[lo:hi],
                mixes=mixes[lo:hi], chunk_bursts=chunk_bursts,
                t_llc_hit=t_llc_hit, device=dev)

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, len(bounds)),
            thread_name_prefix="sweep-mesh") as pool:
        futures = [pool.submit(run, *b) for b in bounds]
        return [m for f in futures for m in f.result()]


def interference_lane_metrics_batch(nvdla_segs: list, *, llcs, drams,
                                    mixes, chunk_bursts: int = 16,
                                    t_llc_hit: int = 20,
                                    mesh=None, way_masks=None,
                                    device=None) -> list[LaneMetrics]:
    """Many interference lanes as lane-batched replays on ``device``
    (``cuda`` when None).

    ``llcs``/``drams``/``mixes`` are equal-length per-lane config
    sequences; lanes are bucketed by set count (``lane_buckets``) so
    padding waste stays bounded, and every bucket runs in ONE replay of
    the segment engine with miss-bit collection
    (``segment_lane_scan_many(collect=True)``, one kernel launch on the
    card).  Per lane, the
    host reconstructs the exact missed-block runs (``_lane_miss_runs``)
    and finishes with the same closed-form DRAM/latency reduction as the
    sequential path, so every ``LaneMetrics`` is bit-identical to
    ``interference_lane_metrics`` for that lane.

    ``mesh`` (a 1-D ``SweepMesh``, see
    ``repro_torch.launch.mesh.make_sweep_mesh``) splits the lane axis
    into contiguous, near-equal slices, one per mesh device; each slice
    replays on its own device (one host thread per slice, so the
    devices' work overlaps) and the results concatenate in lane order,
    bit-identical to ``mesh=None``.  ``device`` is then unused.

    Raises ``ValueError`` if any lane's trace falls outside the segment
    engine's support (stride > block_bytes) — callers fall back to the
    sequential path, which expands such segments exactly.

    ``way_masks`` is an equal-length sequence of per-lane LLC way
    partitions (``int`` victim masks, or ``None`` for unpartitioned
    lanes) — masked and unmasked lanes mix freely in one replay via the
    engine's zero-mask sentinel."""
    lanes_n = len(llcs)
    if not (len(drams) == len(mixes) == lanes_n):
        raise ValueError(
            f"llcs/drams/mixes lengths disagree: {lanes_n}/"
            f"{len(drams)}/{len(mixes)}")
    if way_masks is not None and len(way_masks) != lanes_n:
        raise ValueError(
            f"way_masks length {len(way_masks)} != lanes {lanes_n}")
    if mesh is not None:
        if way_masks is not None:
            raise ValueError("way-masked batches do not support mesh "
                             "sharding yet — pass mesh=None")
        return _mesh_lane_metrics(nvdla_segs, llcs=llcs, drams=drams,
                                  mixes=mixes, chunk_bursts=chunk_bursts,
                                  t_llc_hit=t_llc_hit, mesh=mesh)
    dev = default_device(device)
    if lanes_n == 0:
        return []
    chunks = nvdla_chunks(nvdla_segs, chunk_bursts)
    lanes, nv_masks, lane_sels = [], [], []
    for i, (llc, dram, mix) in enumerate(zip(llcs, drams, mixes)):
        _check_row_block(llc, dram)
        b, s, c, nv = corunner_meta(nvdla_segs, llc=llc, mix=mix,
                                    chunk_bursts=chunk_bursts,
                                    _chunks=chunks)
        lanes.append((b, s, c))
        nv_masks.append(nv)
        wm = way_masks[i] if way_masks is not None else None
        lane_sels.append(None if wm is None
                         else partition_way_sels(nv, llc, wm))
    masked = way_masks is not None
    _check_lane_support_meta(lanes, llcs)
    out: list[LaneMetrics | None] = [None] * lanes_n
    buckets = lane_buckets(llcs)
    batches = []
    for bucket in buckets:
        cfgs_b = [llcs[i] for i in bucket]
        metas_b = [lanes[i] for i in bucket]
        sets, ways, blocks, max_sets, max_ways = _geometry_arrays(cfgs_b)
        s_pad = max(1, max(m[2].shape[0] for m in metas_b))
        shape = (len(bucket), s_pad)
        bases = np.zeros(shape, np.int64)
        strides = np.ones(shape, np.int64)
        counts = np.zeros(shape, np.int64)
        r_needed = np.zeros(shape, np.int64)
        way_sels = np.zeros(shape, np.int64)
        suffix = "none"
        for row, ((b, s, c), cfg) in enumerate(zip(metas_b, cfgs_b)):
            k = c.shape[0]
            bases[row, :k], strides[row, :k], counts[row, :k] = b, s, c
            bb = cfg.block_bytes
            last = b + np.maximum(c - 1, 0) * s
            nb = np.where(c > 0, last // bb - b // bb + 1, 0)
            sel = lane_sels[bucket[row]]
            if sel is not None:
                # way-partitioned lane: every segment retires entirely
                # in the round scan (no analytic suffix for restricted
                # allocation), so the plan is the full ceil(nb / sets)
                way_sels[row, :k] = sel
                r_needed[row, :k] = -(-nb // cfg.sets)
                continue
            # per-lane tight plan: enough rounds to retire the
            # min(nb, ways*sets)-block prefix; no cold short-circuit
            # (conservative cold=False is exact either way)
            r_needed[row, :k] = np.minimum(cfg.ways, -(-nb // cfg.sets))
            overflow = nb - np.minimum(nb, cfg.ways * cfg.sets)
            if np.any(overflow > cfg.sets):
                suffix = "full"
            elif suffix == "none" and np.any(overflow > 0):
                suffix = "one"
        cold = np.zeros(shape, bool)
        # the round-buffer depth only needs to cover this batch's plan,
        # not max_ways — chunked interference traces need 1; the
        # zero-mask sentinel keeps unpartitioned rows on the standard
        # plan inside the same replay
        batches.append(LaneBatch(
            bases, strides, counts, r_needed, cold, sets, ways, blocks,
            way_sels if masked else None, max_sets=max_sets,
            max_ways=max_ways, r_pad=max(1, int(r_needed.max())),
            suffix=suffix))
    # every bucket in one replay: the buckets' chains run side by side
    results = segment_lane_scan_many(batches, collect=True, device=dev)
    for bucket, batch, (hits, miss_bits) in zip(buckets, batches, results):
        for row, i in enumerate(bucket):
            b, s, c = lanes[i]
            n_seg = c.shape[0]
            lane_hits = int(hits[row, :n_seg].sum())
            runs = _lane_miss_runs(b, s, c, llcs[i], batch.cold[row],
                                   miss_bits[row],
                                   full_prefix=lane_sels[i] is not None)
            accesses = int(c.sum())
            run_total = int(runs[1].sum())
            if run_total != accesses - lane_hits:
                raise RuntimeError(
                    "lane miss-run reconstruction disagrees with the "
                    f"engine: {run_total} missed blocks vs "
                    f"{accesses - lane_hits} misses (lane {i})")
            nv = nv_masks[i]
            out[i] = _lane_metrics_from_runs(
                n_segments=n_seg, accesses=accesses, hits=lane_hits,
                runs=runs, bb=llcs[i].block_bytes, nv=nv,
                dram=drams[i], t_llc_hit=t_llc_hit,
                nv_acc=int(c[nv].sum()),
                nv_hits=int(hits[row, :n_seg][nv].sum()))
    return out


def sweep_interference(*, soc=None, corunners=(0, 1, 2, 3, 4),
                       window_bursts: int = 4096,
                       chunk_bursts: int = 16, device=None) -> SweepGrid:
    """Fig. 6, batched: closed-form slowdown curves (``.slowdowns``)
    plus, per (wss, n), the *simulated* NVDLA LLC hit rate with
    co-runner write streams physically interleaved into the trace
    (``.sim_hit_rates``) — every lane a compressed segment stream
    replayed on ``device`` (``cuda`` when None), returned as a typed
    ``SweepGrid``.  All interference lanes share one LLC geometry, so
    each lane runs one exact segment-engine pass that yields per-segment
    hit attribution *and* the exact LLC-miss runs together.  DRAM
    row-hit rates come from the closed-form row model over each lane's
    miss runs (misses of *all* masters mix in the banks, so co-runner
    misses break the NVDLA stream's row locality — the FR-FCFS
    disruption Fig. 6 attributes the "dram" slowdown to)."""
    from repro_torch.core.dram import DRAMConfig
    from repro_torch.core.soc import SoCConfig, interference_sweep as _cf

    soc = soc or SoCConfig()
    cf = _cf(soc=soc, corunners=corunners)
    llc = soc.mem.llc or LLCConfig()
    dram = soc.mem.dram or DRAMConfig()
    if window_bursts is None:
        # full-frame chunk interleaving explodes to ~2M segments/lane —
        # serially infeasible until segment-count compaction lands;
        # refuse loudly rather than run for hours
        raise NotImplementedError(
            "full-frame interference sweeps need RLE segment compaction; "
            "pass a window_bursts cap (the LLC sweep supports full "
            "frames — its lanes stay at stream granularity)")
    nvdla_segs = traces.default_dbb_window(max_bursts=window_bursts)
    # l1-fitting co-runners never reach the shared fabric, so every
    # ('l1', n) lane is the solo-NVDLA trace — simulate it once and fan
    # the result out to all n below
    sim_hit_rates: dict = {}
    sim_row_hit_rates: dict = {}
    for wss, ns in (("l1", (0,)), ("llc", corunners), ("dram", corunners)):
        for n in ns:
            m = interference_lane_metrics(
                nvdla_segs, llc=llc, dram=dram,
                mix=MixConfig(corunners=n, wss=wss),
                chunk_bursts=chunk_bursts, device=device)
            keys = ([(wss, n)] if wss != "l1"
                    else [("l1", k) for k in corunners])
            for key in keys:
                sim_hit_rates[key] = m.nvdla_hit_rate
                sim_row_hit_rates[key] = m.nvdla_miss_row_hit_rate
    return SweepGrid(
        kind="interference",
        slowdowns={wss: cf[wss] for wss in ("l1", "llc", "dram")},
        sim_hit_rates=sim_hit_rates,
        sim_row_hit_rates=sim_row_hit_rates,
        window_bursts=window_bursts)

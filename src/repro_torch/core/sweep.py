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
* ``interference_lane_metrics`` — one co-runner-interleaved lane through
                                 the exact segment engine
                                 (``cache.simulate_segments``) and the
                                 closed-form DRAM row model -> ``LaneMetrics``;
* ``step_lane_metrics``        — one scheduler step's DBB stream, cold or
                                 as the exact marginal cost after a warm
                                 prefix — the serving oracle's entry point.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import traces
from repro_torch.core.cache import (
    LLCConfig,
    _TouchedBlocks,
    segment_lane_scan,
    simulate_segments,
)
from repro_torch.utils.env import default_device

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
    ``way_mask`` (LLC way partitioning) comes with the campaign/farm
    slice of the port and raises here."""
    if way_mask is not None:
        raise NotImplementedError(
            "way_mask lanes (LLC way partitioning) are not ported yet — "
            "ROADMAP, port queue (campaign/farm slice)")
    bb = llc.block_bytes
    _check_row_block(llc, dram)
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

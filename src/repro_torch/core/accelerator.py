"""NVDLA (nv_large) performance model behind a shared LLC + DRAM.

Timing per AccelOp (all in accelerator cycles; NVDLA and the cores share
one 3.2 GHz clock in the paper's FireSim config):

    compute = MACs / (2048 * util)          util = min(1, cin*k*k / 64)
    memory  = bursts * avg_latency / MLP    (latency-bound DBB reads)
              floored by traffic / DRAM-bytes-per-cycle (bandwidth bound)
    layer   = max(compute, memory) + fixed descriptor overhead

The LLC model is the *stream-locality* closed form validated against the
exact simulator in ``repro_torch.core.cache``:
NVDLA's DBB bursts are 32 B and its streams are sequential, so for block
size B the steady-state hit rate is 1 - 32/B — spatial locality only.
Temporal reuse lives in the 512 KiB conv buffer, NOT the LLC (the paper's
central observation: capacity barely matters, block size does).  A small
capacity term survives: an ifmap re-read hits if its producer's ofmap is
still resident (possible only when ofmap + stream footprint fit).

Calibration: {t_llc, t_dram, MLP, overhead} are fit once to the paper's
baseline (67 ms/frame on NVDLA, Table 1 config) and then *held fixed*
across every LLC-sweep and interference experiment — the sweeps are
predictions of the model, compared against Fig. 5/6 in tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import traces
from repro_torch.core.cache import LLCConfig
from repro_torch.core.dram import DRAMConfig
from repro_torch.core.runtime import AccelOp, CommandStream

BURST_BYTES = 32   # NVDLA DBB minimum burst (the paper, sec. 4.1)


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    macs: int = 2048
    conv_buf_bytes: int = 512 * 1024
    freq_hz: float = 3.2e9
    atomic_c: int = 64            # nv_large atomic input-channel depth
    mlp: float = 3.1              # effective DBB memory-level parallelism
    layer_overhead_cycles: int = 12_000   # CSB programming + drain per op


@dataclasses.dataclass(frozen=True)
class MemSystemConfig:
    llc: LLCConfig | None = LLCConfig()
    dram: DRAMConfig = DRAMConfig()
    t_llc_cycles: float = 82.0    # LLC hit latency seen by the DBB
    t_dram_cycles: float = 150.0  # row-hit DRAM latency incl. bus/NoC
    # interference state (set by repro_torch.core.interference)
    extra_dram_latency: float = 0.0
    dram_bw_share: float = 1.0
    llc_eviction_prob: float = 0.0
    bus_delay_cycles: float = 0.0


STREAM_CONFLICT_BLOCKS = 3.0   # competing streams + writebacks per set


def _stream_hit_rate(mem: MemSystemConfig, *, resident_bonus: bool = False,
                     resident_frac: float = 0.0) -> float:
    """LLC hit rate of a sequential 32 B-burst stream.

    spatial term: 1 - 32/B.  In a *tiny* cache the freshly-filled block can
    be conflict-evicted by the other interleaved streams (weights/ifmap/
    ofmap + writebacks) before its remaining bursts return — the survival
    factor n/(n + c) reproduces the paper's mild capacity slope
    (1.17x @ 0.5 KiB -> 1.28x @ 64 KiB, 64 B blocks)."""
    if mem.llc is None:
        return 0.0
    spatial = max(0.0, 1.0 - BURST_BYTES / mem.llc.block_bytes)
    n_blocks = mem.llc.sets * mem.llc.ways
    survive = n_blocks / (n_blocks + STREAM_CONFLICT_BLOCKS)
    h = spatial * survive
    h = h + (1.0 - h) * (resident_frac if resident_bonus else 0.0)
    return h * (1.0 - mem.llc_eviction_prob)


def _residency_fraction(op: AccelOp, mem: MemSystemConfig) -> float:
    """Fraction of ifmap reads that hit because the producer's ofmap is
    still LLC-resident.  Weak by construction — between the producer's
    write and this op's ifmap read, this op's own *weight stream* has
    already swept the cache, so residency needs llc_size > weight_traffic
    with only the remainder holding ofmap blocks.  This is why the paper
    sees only a mild capacity slope even at 4 MiB."""
    if mem.llc is None or op.prev_ofmap_bytes == 0:
        return 0.0
    leftover = mem.llc.size_bytes - op.weight_traffic
    if leftover <= 0:
        return 0.0
    return 0.5 * min(1.0, leftover / op.prev_ofmap_bytes)


def op_cycles(op: AccelOp, acc: AccelConfig, mem: MemSystemConfig,
              hit_rates: tuple[float, float, float] | None = None) -> dict:
    """One AccelOp's cycle breakdown.  ``hit_rates`` overrides the
    closed-form stream-locality model with measured (weight, ifmap,
    ofmap) LLC hit rates — the sim-driven mode feeds the exact segment
    simulator's per-layer rates here (``op_stream_hit_rates``).  The
    interference eviction term still applies on top, so co-runner
    modeling composes with either source."""
    l = op.layer
    if op.macs:
        util = min(1.0, (l.cin * l.ksize * l.ksize) / acc.atomic_c)
        compute = op.macs / (acc.macs * util)
    else:
        compute = op.ifmap_traffic / 32.0   # SDP elementwise throughput

    t_dram = (mem.t_dram_cycles + mem.extra_dram_latency)
    t_llc = mem.t_llc_cycles + mem.bus_delay_cycles
    t_dram = t_dram + mem.bus_delay_cycles

    if hit_rates is not None:
        scale = 1.0 - mem.llc_eviction_prob
        h_w, h_i, h_o = (h * scale for h in hit_rates)
    else:
        h_w = _stream_hit_rate(mem)
        h_i = _stream_hit_rate(mem, resident_bonus=True,
                               resident_frac=_residency_fraction(op, mem))
        h_o = _stream_hit_rate(mem)

    def stream_cycles(traffic, h):
        if traffic == 0:
            return 0.0
        bursts = traffic / BURST_BYTES
        lat = h * t_llc + (1.0 - h) * t_dram
        return bursts * lat / acc.mlp

    latency_cycles = (stream_cycles(op.weight_traffic, h_w)
                      + stream_cycles(op.ifmap_traffic, h_i)
                      + stream_cycles(op.ofmap_traffic, h_o))
    # DRAM bandwidth floor: only misses reach DRAM
    miss_bytes = (op.weight_traffic * (1 - h_w)
                  + op.ifmap_traffic * (1 - h_i)
                  + op.ofmap_traffic * (1 - h_o))
    bw_bytes_per_cycle = (mem.dram.peak_bw / acc.freq_hz) * mem.dram_bw_share
    bw_cycles = miss_bytes / bw_bytes_per_cycle
    memory = max(latency_cycles, bw_cycles)
    total = max(compute, memory) + acc.layer_overhead_cycles
    return {"compute": compute, "memory": memory, "total": total,
            "hit_rates": (h_w, h_i, h_o)}


def op_stream_hit_rates(stream: CommandStream, mem: MemSystemConfig,
                        max_ops: int | None = None, *, device=None
                        ) -> list[tuple[float, float, float]]:
    """Exact per-op (weight, ifmap, ofmap) LLC hit rates from the
    compressed segment engine, one pass over the whole network's DBB
    trace with LLC state carried across ops — so an op's ifmap reads
    really do hit on its producer's still-resident ofmap blocks, and a
    restreamed weight region really is warm.  This is what
    ``mode="simulated"`` feeds into ``op_cycles`` in place of the
    closed-form stream model.  The replay is a one-lane
    ``segment_lane_hit_counts`` on ``device`` (``cuda`` when None)."""
    from repro_torch.core.sweep import segment_lane_hit_counts

    ops = stream.accel_ops[:max_ops] if max_ops else stream.accel_ops
    if mem.llc is None:
        return [(0.0, 0.0, 0.0)] * len(ops)
    per_op = traces.network_op_segments(stream, max_ops)
    flat = [s for segs in per_op for s in segs]
    counts = segment_lane_hit_counts(flat, [mem.llc], device=device)
    return _fold_op_stream_rates(per_op, counts[0])


def _fold_op_stream_rates(per_op, per_segment_hits
                          ) -> list[tuple[float, float, float]]:
    """Fold flat per-segment hit counts back into per-op (weight, ifmap,
    ofmap) rates, following the op/stream structure of ``per_op``."""
    rates: list[tuple[float, float, float]] = []
    k = 0
    for segs in per_op:
        tot = {"weight": [0, 0], "ifmap": [0, 0], "ofmap": [0, 0]}
        for s in segs:
            tot[s.stream][0] += int(per_segment_hits[k])
            tot[s.stream][1] += s.count
            k += 1
        rates.append(tuple(t[0] / t[1] if t[1] else 0.0
                           for t in (tot["weight"], tot["ifmap"],
                                     tot["ofmap"])))
    return rates


def op_stream_hit_rates_grid(stream: CommandStream,
                             llc_configs: list[LLCConfig],
                             max_ops: int | None = None, *, device=None
                             ) -> list[list[tuple[float, float, float]]]:
    """``op_stream_hit_rates`` for a whole geometry grid at once: the
    full-network trace replays through the bucketed lane-batched segment
    engine (``repro_torch.core.sweep.segment_lane_hit_counts``) on
    ``device``.  ``max_ops`` truncates the stream like the pointwise
    function's parameter (prefix replay — smoke-scale grids).  Returns
    one per-op rate list per config, exactly what each
    ``accel_time_s(hit_rates=...)`` call needs."""
    from repro_torch.core.sweep import segment_lane_hit_counts

    per_op = traces.network_op_segments(stream, max_ops)
    flat = [s for segs in per_op for s in segs]
    counts = segment_lane_hit_counts(flat, llc_configs, device=device)
    return [_fold_op_stream_rates(per_op, counts[g])
            for g in range(len(llc_configs))]


def accel_time_s(stream: CommandStream, *, acc: AccelConfig,
                 mem: MemSystemConfig, mode: str = "model",
                 hit_rates: list | None = None, device=None) -> dict:
    """NVDLA-side frame time.  ``mode="model"`` uses the closed-form
    stream-locality hit rates (the calibrated paper model);
    ``mode="simulated"`` drives every layer's hit rates from the exact
    segment simulator on that layer's real DBB trace, run on ``device``
    (``hit_rates`` short-circuits the simulation when the caller already
    has them — e.g. a sweep reusing one simulation across co-runner
    counts)."""
    if mode not in ("model", "simulated"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "simulated" and hit_rates is None:
        hit_rates = op_stream_hit_rates(stream, mem, device=device)
    if hit_rates is not None and len(hit_rates) != len(stream.accel_ops):
        raise ValueError(
            f"{len(hit_rates)} hit-rate tuples for "
            f"{len(stream.accel_ops)} accel ops — hit_rates must cover "
            "every op of this stream")
    if hit_rates is None:
        per_layer = [op_cycles(op, acc, mem) for op in stream.accel_ops]
    else:
        per_layer = [op_cycles(op, acc, mem, hit_rates=hr)
                     for op, hr in zip(stream.accel_ops, hit_rates)]
    cycles = sum(p["total"] for p in per_layer)
    return {
        "cycles": cycles,
        "seconds": cycles / acc.freq_hz,
        "per_layer": per_layer,
        "mode": mode,
        "compute_bound_layers": sum(
            1 for p in per_layer if p["compute"] >= p["memory"]),
    }


def recalibrate_stream_conflict(sim_hit_rates: dict) -> dict:
    """Re-fit ``STREAM_CONFLICT_BLOCKS`` against a *simulated* Fig. 5
    grid ({(size_kib, block): exact hit rate}, e.g. from
    ``segment_lane_hit_rates`` over ``sweep.grid_configs``).

    The closed form says h = (1 - 32/B) * n/(n + c) with n the cache's
    block count; each grid point solves for c, the fit is their median
    (robust to the few points where capacity effects the closed form
    deliberately ignores dominate), and both the shipped and fitted
    constants get an RMS report — benchmarks assert the shipped value
    stays inside the simulated fit's neighbourhood instead of drifting
    from the paper anchors."""
    from repro_torch.core.soc import llc_config_for

    pts, fits = [], []
    for (size, block), h in sim_hit_rates.items():
        cfg = llc_config_for(size, block)
        spatial = max(0.0, 1.0 - BURST_BYTES / block)
        n = cfg.sets * cfg.ways
        pts.append((spatial, n, h))
        if 0.0 < h < spatial:
            fits.append(n * (spatial / h - 1.0))
    c_fit = float(np.median(fits)) if fits else STREAM_CONFLICT_BLOCKS

    def rms(c: float) -> float:
        err = [s * n / (n + c) - h for s, n, h in pts]
        return float(np.sqrt(np.mean(np.square(err)))) if err else 0.0

    return {"stream_conflict_blocks": c_fit,
            "shipped": STREAM_CONFLICT_BLOCKS,
            "rms_shipped": rms(STREAM_CONFLICT_BLOCKS),
            "rms_fit": rms(c_fit),
            "points": len(pts)}

"""Token-level SoC memory pipeline — the paper's Figure 2, executable.

Composes the exact LLC simulator and the DRAM row/bank model as FAME-1
components behind the NVDLA DBB: each *target* cycle one DBB burst
address flows  DBB -> LLC (hit/miss classification, LRU update) ->
DRAM (row hit/miss service latency for LLC misses).  Host stalls may gate
any component on any host cycle (FireSim's situation when the host FPGA's
DRAM is slow) — the per-access latencies and every cache/bank state are
bit-identical regardless (tests/test_torch_socsim.py, against the
reference package under random schedules).

This is the mechanism layer under ``repro_torch.core.accelerator``'s
closed-form timing: where the closed form aggregates streams
statistically, this pipeline replays an actual burst trace cycle by
cycle, each component's state a tensor on the device.  On the CPU the
generic ``FAME1Pipeline`` steps each component once a fired token (the
plain version); on ``cuda`` ``simulate_dbb_stream`` plans the same fires
on the host and computes the components' steps with no per-token op:
the LLC as one ``llc_set_walk`` launch, the DRAM by a sort and a
neighbour compare over the misses (``_stream_on_card``).  For latency
*totals* ``simulate_dbb_segments`` composes the compressed segment
engine (``repro_torch.core.cache.simulate_segments``) with the
closed-form DRAM row model (``repro_torch.core.dram.segment_row_hits``),
so the whole pipeline result comes out of segment-level arithmetic —
bit-identical to the per-access pipeline.  Configs are keyword-only
(``llc=``, ``dram=``); a positional config is a ``TypeError``.
Addresses are int64 tensors (``repro_torch.utils.env``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cache import LLCConfig, walk_by_set
from repro_torch.utils.address import fdiv
from repro_torch.core.dram import DRAMConfig, open_row_hits
from repro_torch.core.fame1 import Component, FAME1Pipeline, plan_schedule
from repro_torch.utils.env import as_address_tensor, default_device


def llc_component(cfg: LLCConfig, *, device=None) -> Component:
    """True-LRU LLC as a FAME-1 component: per-set **age** counters; a
    hit touches the first matching way, a miss evicts the first way of
    greatest age (``argmax``'s first-index tie-break), the touched way's
    age resets and every other way of the set ages by one."""
    dev = default_device(device)
    sets, ways, bb = cfg.sets, cfg.ways, cfg.block_bytes
    q_idx = torch.arange(ways, device=dev)

    def step(state, addr):
        tags, age = state
        block = fdiv(addr, bb)
        s = torch.remainder(block, sets)
        t = fdiv(block, sets)
        row_tags, row_age = tags[s], age[s]
        match = row_tags == t
        hit = match.any()
        way = torch.where(hit, torch.argmax(match.to(torch.int8)),
                          torch.argmax(row_age))
        tags = tags.index_put((s, way), t)
        age = age.index_put((s,), torch.where(q_idx == way, 0, row_age + 1))
        return (tags, age), {"addr": addr, "hit": hit}

    init = (torch.full((sets, ways), -1, dtype=torch.int64, device=dev),
            torch.zeros((sets, ways), dtype=torch.int32, device=dev))
    return Component("llc", step, init,
                     {"addr": torch.zeros((), dtype=torch.int64, device=dev),
                      "hit": torch.zeros((), dtype=torch.bool, device=dev)})


def dram_component(llc_cfg: LLCConfig, dram_cfg: DRAMConfig,
                   t_llc_hit: int = 20, *, device=None) -> Component:
    dev = default_device(device)
    banks = dram_cfg.banks
    t_miss = (dram_cfg.t_rp_cycles + dram_cfg.t_rcd_cycles
              + dram_cfg.t_cas_cycles)

    def step(open_rows, tok):
        addr, hit = tok["addr"], tok["hit"]
        row = fdiv(addr, dram_cfg.row_bytes)
        bank = torch.remainder(row, banks)
        row_of_bank = fdiv(row, banks)
        row_hit = open_rows[bank] == row_of_bank
        dram_lat = torch.where(row_hit, dram_cfg.t_cas_cycles, t_miss)
        # a miss pays the LLC lookup AND the DRAM access
        lat = torch.where(hit, t_llc_hit, t_llc_hit + dram_lat).to(torch.int32)
        # only LLC misses touch DRAM state (no row activation on a hit)
        open_rows = torch.where(
            hit, open_rows, open_rows.index_put((bank,), row_of_bank))
        return open_rows, lat

    return Component("dram", step,
                     torch.full((banks,), -1, dtype=torch.int64, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


@dataclasses.dataclass
class MemPipelineResult:
    latencies: torch.Tensor     # (T,) per-access service latency
    total_cycles: torch.Tensor  # sum
    host_cycles: int | None = None   # host cycles the scheduler spent


def simulate_dbb_stream(byte_addrs, *, llc: LLCConfig,
                        dram: DRAMConfig | None = None,
                        host_stalls=None, early_exit: bool = True,
                        device=None) -> MemPipelineResult:
    """Replay a DBB burst-address trace through the LLC -> DRAM pipeline
    on ``device`` (``cuda`` when None).

    ``host_stalls`` is an (H, 2) bool schedule (tensor or array; True =
    stall that component that host cycle), made by the caller from a
    seeded generator.  ``early_exit=False`` replays the fixed-length
    host schedule; results are bit-identical either way, and
    ``host_cycles`` is the reference scheduler's exact count.  On
    ``cuda`` the LLC is one ``llc_set_walk`` launch at any way count (a
    set a lane up to 128 ways, a set a warp past that), with no plain
    fallback; the CPU replays the per-token pipeline.
    """
    dev = default_device(device)
    dram = dram or DRAMConfig()
    addrs = as_address_tensor(byte_addrs, device=dev,
                              what="DBB byte address")
    max_host = host_stalls.shape[0] if host_stalls is not None else None
    t = addrs.shape[0]
    if _on_card(addrs):
        fires, drained, cycles = plan_schedule(
            t, 2, host_stalls, max_host, early_exit=early_exit)
        _, lats = _stream_on_card(addrs, llc, dram, fires, drained)
        return MemPipelineResult(latencies=lats, total_cycles=lats.sum(),
                                 host_cycles=cycles)
    pipe = FAME1Pipeline([llc_component(llc, device=dev),
                          dram_component(llc, dram, device=dev)])
    _, lats, _ = pipe.run(addrs, host_stalls=host_stalls,
                          max_host_cycles=max_host, early_exit=early_exit)
    return MemPipelineResult(latencies=lats[:t],
                             total_cycles=lats[:t].sum(),
                             host_cycles=pipe.last_host_cycles)


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA device, where the stream takes the
    kernel route."""
    return x.device.type == "cuda"


def _stream_on_card(addrs: torch.Tensor, llc: LLCConfig, dram: DRAMConfig,
                    fires: list[int], drained: int, t_llc_hit: int = 20):
    """The planned pipeline's target-visible result without a per-token
    op: what ``FAME1Pipeline.run`` over ``llc_component`` and
    ``dram_component`` returns for the host schedule ``fires`` /
    ``drained`` (``fame1.plan_schedule``), bit for bit.

    The LLC component over its first ``fires[0]`` tokens is one
    ``llc_set_walk`` launch from a cold state (``cache.walk_by_set``):
    every access count 1, the arrivals ranked by set with a stable sort,
    tags made dense by ``torch.unique`` (the walk only tests them for
    equality; the final tags map back), so that address-wide tags never
    pass through int32.  The DRAM component over the first
    ``fires[1]`` LLC outputs: an LLC miss hits its row iff the previous
    miss to its bank opened the same row (hits leave the open rows
    alone), a stable sort of the misses by bank and a neighbour compare.
    Returns (((tags int64, age int32), open_rows int64), latencies (T,)
    int32, zero past ``drained``)."""
    dev = addrs.device
    n_llc, n_dram = fires
    sets, ways, bb = llc.sets, llc.ways, llc.block_bytes
    block = fdiv(addrs[:n_llc], bb)
    set_a = torch.remainder(block, sets)
    tags = torch.full((sets, ways), -1, dtype=torch.int64, device=dev)
    age = torch.zeros((sets, ways), dtype=torch.int32, device=dev)
    hit = torch.zeros(n_llc, dtype=torch.bool, device=dev)
    if n_llc:
        uniq, tag_a = torch.unique(fdiv(block, sets), return_inverse=True)
        hit, dense, age = walk_by_set(
            tags.to(torch.int32), age, set_a, tag_a.to(torch.int32),
            torch.ones(n_llc, dtype=torch.int32, device=dev))
        tags = torch.where(dense >= 0, uniq[dense.clamp(min=0).long()], -1)

    t_miss = dram.t_rp_cycles + dram.t_rcd_cycles + dram.t_cas_cycles
    miss = torch.nonzero(~hit[:n_dram]).flatten()
    row_hit, open_rows = open_row_hits(fdiv(addrs[miss], dram.row_bytes),
                                       dram.banks)
    lat = torch.full((n_dram,), t_llc_hit, dtype=torch.int32, device=dev)
    lat[miss] = (t_llc_hit + torch.where(row_hit, dram.t_cas_cycles,
                                         t_miss)).to(torch.int32)
    out = torch.zeros(addrs.shape[0], dtype=torch.int32, device=dev)
    out[:drained] = lat[:drained]
    return ((tags, age), open_rows), out


# --------------------------------------------------------------------------
# segment-native totals: no per-access replay at all
# --------------------------------------------------------------------------
class PipelineInvariantError(ValueError):
    """A memory-pipeline result violates a closed-form invariant — the
    numbers cannot have come from a correct simulation (a poisoned
    worker, a corrupted record, an injected fault)."""


def check_segment_totals(*, accesses: int, llc_hits: int,
                         dram_row_hits: int, total_cycles: int,
                         dram: DRAMConfig, t_llc_hit: int = 20) -> None:
    """Validate a (accesses, hits, row hits, total) quadruple against
    the closed-form latency identity of ``simulate_dbb_segments``:

        total = T*t_llc_hit + misses*tCAS + row_misses*(tRP + tRCD)

    plus the counting invariants 0 <= hits <= accesses and
    0 <= row_hits <= misses.  Raises ``PipelineInvariantError`` with the
    failing relation spelled out."""
    vals = (accesses, llc_hits, dram_row_hits, total_cycles)
    if not all(isinstance(v, int) for v in vals):
        raise PipelineInvariantError(
            f"pipeline counters must be ints, got {vals!r}")
    if accesses < 0 or llc_hits < 0 or dram_row_hits < 0:
        raise PipelineInvariantError(
            f"negative pipeline counter: accesses={accesses} "
            f"llc_hits={llc_hits} dram_row_hits={dram_row_hits}")
    if llc_hits > accesses:
        raise PipelineInvariantError(
            f"llc_hits {llc_hits} exceeds accesses {accesses}")
    misses = accesses - llc_hits
    if dram_row_hits > misses:
        raise PipelineInvariantError(
            f"dram_row_hits {dram_row_hits} exceeds LLC misses {misses}")
    expect = (accesses * t_llc_hit + misses * dram.t_cas_cycles
              + (misses - dram_row_hits)
              * (dram.t_rp_cycles + dram.t_rcd_cycles))
    if total_cycles != expect:
        raise PipelineInvariantError(
            f"total_cycles {total_cycles} != closed form {expect} "
            f"(accesses={accesses} misses={misses} "
            f"row_hits={dram_row_hits})")


def check_segment_totals_batch(*, accesses, llc_hits, dram_row_hits,
                               total_cycles, drams,
                               t_llc_hit: int = 20) -> None:
    """Vectorized ``check_segment_totals`` over a point batch.  All four
    counter arguments are equal-length sequences of ints, ``drams`` the
    per-point DRAM configs.  Raises ``PipelineInvariantError`` naming
    every failing batch index (one bad point must not mask another)."""
    acc = np.asarray(accesses, np.int64)
    hits = np.asarray(llc_hits, np.int64)
    row = np.asarray(dram_row_hits, np.int64)
    tot = np.asarray(total_cycles, np.int64)
    n = len(acc)
    if not (len(hits) == len(row) == len(tot) == len(drams) == n):
        raise PipelineInvariantError(
            "batch counter sequences have mismatched lengths")
    misses = acc - hits
    t_cas = np.asarray([d.t_cas_cycles for d in drams], np.int64)
    t_act = np.asarray([d.t_rp_cycles + d.t_rcd_cycles for d in drams],
                       np.int64)
    expect = acc * t_llc_hit + misses * t_cas + (misses - row) * t_act
    bad = ((acc < 0) | (hits < 0) | (row < 0) | (hits > acc)
           | (row > misses) | (tot != expect))
    if bad.any():
        idxs = np.nonzero(bad)[0]
        details = ", ".join(
            f"[{i}] accesses={acc[i]} llc_hits={hits[i]} "
            f"row_hits={row[i]} total={tot[i]} expect={expect[i]}"
            for i in idxs[:8])
        raise PipelineInvariantError(
            f"{idxs.size}/{n} batch points violate the pipeline "
            f"invariants: {details}")


@dataclasses.dataclass
class SegmentPipelineResult:
    total_cycles: int            # == simulate_dbb_stream(...).total_cycles
    accesses: int
    llc_hits: int
    dram_row_hits: int           # row hits among the LLC misses

    @property
    def llc_hit_rate(self) -> float:
        return self.llc_hits / max(1, self.accesses)

    @property
    def mean_latency(self) -> float:
        return self.total_cycles / max(1, self.accesses)

    def check_invariants(self, dram: DRAMConfig,
                         t_llc_hit: int = 20) -> "SegmentPipelineResult":
        """Raise ``PipelineInvariantError`` unless the counters satisfy
        the closed-form identities; returns self for chaining."""
        check_segment_totals(
            accesses=self.accesses, llc_hits=self.llc_hits,
            dram_row_hits=self.dram_row_hits,
            total_cycles=self.total_cycles,
            dram=dram, t_llc_hit=t_llc_hit)
        return self


def simulate_dbb_segments(segments, *, llc: LLCConfig,
                          dram: DRAMConfig | None = None,
                          t_llc_hit: int = 20,
                          device=None) -> SegmentPipelineResult:
    """Latency totals of the LLC -> DRAM pipeline over a *compressed*
    DBB trace, with no per-access replay on either side; the LLC rounds
    run on ``device`` (``cuda`` when None).

    The segment LLC engine classifies hits and emits the exact miss
    stream as runs of consecutive blocks; the closed-form DRAM row model
    counts row hits over those runs with per-bank open-row carry.  Since
    every per-access latency is determined by (llc hit?, dram row hit?),
    the totals are bit-identical to ``simulate_dbb_stream`` on the
    expanded trace:

        total = T*t_llc_hit + misses*tCAS + row_misses*(tRP + tRCD)

    Requires ``dram.row_bytes % llc.block_bytes == 0`` (every standard
    geometry) so a missed block's row is independent of which burst in
    the block missed.
    """
    from repro_torch.core.cache import simulate_segments
    from repro_torch.core.dram import segment_row_hits

    dram = dram or DRAMConfig()
    bb = llc.block_bytes
    if dram.row_bytes % bb:
        raise ValueError(
            f"row_bytes {dram.row_bytes} not a multiple of block_bytes "
            f"{bb}: a block could straddle rows; use simulate_dbb_stream")
    res = simulate_segments(segments, llc, collect_miss_runs=True,
                            device=device)
    row = segment_row_hits([(b * bb, bb, c) for b, c, _ in res.miss_runs],
                           dram)
    misses = res.accesses - res.hits
    row_misses = misses - row.row_hits
    total = (res.accesses * t_llc_hit
             + misses * dram.t_cas_cycles
             + row_misses * (dram.t_rp_cycles + dram.t_rcd_cycles))
    return SegmentPipelineResult(total_cycles=int(total),
                                 accesses=res.accesses,
                                 llc_hits=res.hits,
                                 dram_row_hits=row.row_hits)

"""DRAM timing model: banks, open rows, FR-FCFS-style row-hit priority.

Matches the FireSim memory-model knobs the paper uses (DDR3, 4 ranks x 8
banks, FR-FCFS).  The accelerator timing model reads the peak bandwidth
from here.  ``access_latencies`` is the exact per-access open-row model
on the device; for stride-run segment streams (the compressed DBB traces of
``repro_torch.core.traces`` and the LLC miss runs of
``repro_torch.core.cache.simulate_segments``) ``segment_row_hits``
counts row hits in closed form: rows touched per segment, per-bank
open-row carry across segment boundaries, bit-identical to a per-access
open-row scan with O(segments * banks) numpy work.  Row hit ->
tCAS; row miss -> tRP + tRCD + tCAS.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.env import as_address_tensor, default_device


@dataclasses.dataclass(frozen=True)
class DRAMConfig:
    banks: int = 32                  # 4 ranks x 8 banks
    row_bytes: int = 2048
    t_cas_cycles: int = 14           # DDR3-1600-ish, in memory-clock cycles
    t_rcd_cycles: int = 14
    t_rp_cycles: int = 14
    clock_hz: float = 800e6          # memory controller clock
    bus_bytes_per_cycle: int = 16    # 64-bit DDR -> 16 B / controller cycle

    @property
    def peak_bw(self) -> float:
        return self.clock_hz * self.bus_bytes_per_cycle


def access_latencies(byte_addrs, *, banks: int, row_bytes: int,
                     t_cas: int, t_rcd: int, t_rp: int,
                     device=None) -> torch.Tensor:
    """byte_addrs (T,) -> per-access latency in memory cycles (exact
    open-row bookkeeping; no queueing), on ``device`` (``cuda`` when
    None).  Banks start closed; an access hits iff the previous access
    to its bank opened the same row, so the serial open-row scan is a
    stable sort by bank and a neighbour compare — bit-identical to the
    reference's per-access scan."""
    dev = default_device(device)
    row = torch.div(as_address_tensor(byte_addrs, device=dev,
                                      what="DRAM byte address"),
                    row_bytes, rounding_mode="floor")
    hit, _ = open_row_hits(row, banks)
    return torch.where(hit, t_cas, t_rp + t_rcd + t_cas)


def open_row_hits(row: torch.Tensor, banks: int):
    """The open-row scan of the DRAM rows ``row`` (int64, in access
    order) with every bank closed at the start: an access hits iff the
    previous access to its bank opened the same row, so the scan is a
    stable sort by bank and a neighbour compare.  Returns (hit bits in
    access order, each bank's open row after the last access as a row
    of that bank, -1 where none opened one)."""
    bank = torch.remainder(row, banks)
    row_of_bank = torch.div(row, banks, rounding_mode="floor")
    order = torch.sort(bank, stable=True).indices
    b_s, r_s = bank[order], row_of_bank[order]
    same_bank = b_s[1:] == b_s[:-1]
    hit_s = torch.zeros_like(b_s, dtype=torch.bool)
    hit_s[1:] = same_bank & (r_s[1:] == r_s[:-1])
    hit = torch.empty_like(hit_s)
    hit[order] = hit_s
    # each bank's last access: the end of its run in the sorted order
    last = torch.ones_like(hit_s)
    last[:-1] = ~same_bank
    open_rows = torch.full((banks,), -1, dtype=torch.int64, device=row.device)
    open_rows[b_s[last]] = r_s[last]
    return hit, open_rows


def row_hit_rate(byte_addrs, cfg: DRAMConfig, *, device=None) -> float:
    """Fraction of accesses served from an open row, in float32 as the
    reference's mean computes it: the row-hit count times the float32
    reciprocal of the access count."""
    lats = access_latencies(byte_addrs, banks=cfg.banks,
                            row_bytes=cfg.row_bytes, t_cas=cfg.t_cas_cycles,
                            t_rcd=cfg.t_rcd_cycles, t_rp=cfg.t_rp_cycles,
                            device=device)
    hits = int((lats == cfg.t_cas_cycles).sum())
    return float(np.float32(hits)
                 * (np.float32(1) / np.float32(lats.shape[0])))


# --------------------------------------------------------------------------
# closed-form row model for stride-run segments
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RowHitResult:
    row_hits: int                # accesses served from an open row
    accesses: int
    open_rows: np.ndarray        # final per-bank open row ids (-1 closed)
    per_segment: np.ndarray      # (n_segments,) int64 row hits

    @property
    def row_hit_rate(self) -> float:
        return self.row_hits / max(1, self.accesses)


def _bank_first_last_rows(r0: int, r1: int, banks: int):
    """For the contiguous row run [r0, r1]: each bank's first and last
    visited row (full row ids), and which banks are visited at all."""
    b = np.arange(banks, dtype=np.int64)
    first = r0 + ((b - r0) % banks)
    last = r1 - ((r1 - b) % banks)
    visited = first <= r1
    return first, last, visited


def _row_hits_bulk(base: np.ndarray, stride: np.ndarray, count: np.ndarray,
                   banks: int, rb: int, rows_state: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized carry chain for stride <= row_bytes segments: the
    per-bank open-row state a segment observes is the ``last`` row of
    the most recent earlier segment that visited the bank (exclusive
    running maximum over visit indices), so the whole serial loop
    collapses to O(segments * banks) numpy with no Python per segment.
    Returns (per_segment row hits, final open rows) — bit-identical to
    the scalar loop."""
    n = base.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), rows_state[:banks].copy()
    live = count > 0
    r0 = base // rb
    r1 = (base + np.maximum(count - 1, 0) * stride) // rb
    b = np.arange(banks, dtype=np.int64)[None, :]
    first = r0[:, None] + ((b - r0[:, None]) % banks)
    last = r1[:, None] - ((r1[:, None] - b) % banks)
    visited = (first <= r1[:, None]) & live[:, None]
    idx = np.where(visited, np.arange(n, dtype=np.int64)[:, None], -1)
    latest = np.maximum.accumulate(idx, axis=0)
    prev = np.vstack([np.full((1, banks), -1, np.int64), latest[:-1]])
    prev_last = np.where(
        prev >= 0,
        np.take_along_axis(last, np.maximum(prev, 0), axis=0),
        rows_state[None, :banks])
    carry = (visited & (prev_last == first)).sum(axis=1)
    per_seg = np.where(live, count - (r1 - r0 + 1) + carry, 0)
    final = np.where(
        latest[-1] >= 0,
        np.take_along_axis(last, np.maximum(latest[-1:], 0), axis=0)[0],
        rows_state[:banks])
    return per_seg.astype(np.int64), final.astype(np.int64)


def segment_row_hits(segments, cfg: DRAMConfig,
                     open_rows: np.ndarray | None = None) -> RowHitResult:
    """Row-hit count of a compressed stride-run trace, closed form.

    Bit-identical to replaying the expanded trace through a per-access
    open-row scan (the reference's ``access_latencies``), with serial
    work O(segments * banks) instead of O(accesses):

    * a segment with stride <= row_bytes sweeps the contiguous row run
      [base//row_bytes, last//row_bytes]; every row is visited once,
      contiguously, so all accesses beyond each row's first hit that
      open row, and a row's *first* access can only hit via the open-row
      state carried in from earlier segments — possible only for each
      bank's first visited row (later visits to a bank always follow an
      intra-segment activation of a different row of that bank);
    * a segment with stride > row_bytes touches a strictly increasing,
      gappy row sequence — rare (never produced by DBB streams or LLC
      miss runs), replayed per access with the same open-row carry.

    ``open_rows`` continues from a prior result's state (full row ids,
    -1 = closed); segments may be ``Segment`` objects or
    ``(base, stride, count)`` tuples, base/stride in bytes.
    """
    from repro_torch.core.traces import segment_tuple

    banks, rb = cfg.banks, cfg.row_bytes
    rows_state = (np.full(banks, -1, np.int64) if open_rows is None
                  else np.array(open_rows, np.int64, copy=True))
    if isinstance(segments, tuple) and len(segments) == 3 \
            and isinstance(segments[0], np.ndarray):
        base_a, stride_a, count_a = (np.asarray(a, np.int64)
                                     for a in segments)
    else:
        seg_list = [segment_tuple(s) for s in segments]
        base_a = np.asarray([m[0] for m in seg_list], np.int64)
        stride_a = np.asarray([m[1] for m in seg_list], np.int64)
        count_a = np.asarray([m[2] for m in seg_list], np.int64)
    live_a = count_a > 0
    if np.any(live_a & (stride_a <= 0)):
        bad = int(stride_a[live_a & (stride_a <= 0)][0])
        raise ValueError(f"segment stride must be positive: {bad}")
    if not np.any(live_a & (stride_a > rb)):
        per_seg, rows_state = _row_hits_bulk(
            base_a, stride_a, count_a, banks, rb, rows_state)
        return RowHitResult(row_hits=int(per_seg.sum()),
                            accesses=int(count_a[live_a].sum()),
                            open_rows=rows_state, per_segment=per_seg)
    seg_list = list(zip(base_a.tolist(), stride_a.tolist(),
                        count_a.tolist()))
    per_seg = np.zeros(len(seg_list), np.int64)
    accesses = 0
    for i, (base, stride, count) in enumerate(seg_list):
        if count <= 0:
            continue
        if stride <= 0:
            raise ValueError(f"segment stride must be positive: {stride}")
        accesses += count
        if stride > rb:
            # gappy rows: every access opens (or re-hits) its own row
            rows = (base + np.arange(count, dtype=np.int64) * stride) // rb
            hits = 0
            for r in rows:
                b = int(r % banks)
                hits += rows_state[b] == r
                rows_state[b] = r
            per_seg[i] = hits
            continue
        r0 = base // rb
        r1 = (base + (count - 1) * stride) // rb
        first, last, visited = _bank_first_last_rows(r0, r1, banks)
        carry_hits = int((visited & (rows_state[:banks] == first)).sum())
        per_seg[i] = count - (r1 - r0 + 1) + carry_hits
        rows_state = np.where(visited, last, rows_state)
    return RowHitResult(row_hits=int(per_seg.sum()), accesses=accesses,
                        open_rows=rows_state, per_segment=per_seg)

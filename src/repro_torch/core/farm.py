"""Multi-node SoC farm: N accelerator nodes behind one token-routed NoC.

FireSim scales past one FPGA by connecting simulated nodes through a
cycle-token switch; this module is that farm for the paper's SoC model.
A *victim* node (an NVDLA or NPU trace compiler's DBB stream, chunked
into requests) and ``nodes`` bandwidth co-runner nodes all target one
shared memory port of a ``repro_torch.core.noc`` switch, and the shared
LLC/DRAM behind that port is the interference lane of
``repro_torch.core.sweep`` — so one farm simulation composes the two
exact halves of a request's latency:

* **interconnect** — the victim's per-request flit latency through the
  switch (queueing behind co-runner flits + link latency), cycle-exact
  under deterministic round-robin arbitration and FAME-1 token-bundle
  execution;
* **memory** — the per-request (per-chunk) LLC/DRAM service latency
  from ``lane_request_latencies``, with the co-runners' write streams
  physically interleaved into the victim's trace, optionally under an
  LLC way partition (``way_mask``) that fences the victim's ways off
  from co-runner allocation.

The victim injects one flit per request every ``victim_gap`` cycles
(offered load ``1 / victim_gap``); each co-runner node injects every
``corunner_gap`` cycles.  The memory egress moves one flit per cycle,
so total offered load beyond 1.0 saturates it and victim queueing grows
through the window — the mechanism behind the superlinear p99 tail of
the Fig. 6 tail suite.  Way partitioning recovers the *memory* half of
the tail (protected LLC ways keep the victim's cross-pass reuse); the
interconnect half is policy-free contention.

``passes=2`` (the default) replays the victim window twice so the
second pass measures steady-state reuse — the serving-engine view,
where a decode step re-references the working set the previous step
left in the LLC.  ``FarmResult.steady`` slices the per-request arrays
to that final pass.  Both the lane and the switch run on ``device``
(``cuda`` when None).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cache import LLCConfig
from repro_torch.core.noc import NoCConfig, NoCResult, NoCSwitch
from repro_torch.core.sweep import (
    LaneMetrics,
    MixConfig,
    lane_request_latencies,
)


@dataclasses.dataclass(frozen=True)
class FarmConfig:
    """Farm topology and injection timing (target cycles).

    ``nodes`` co-runner nodes ride beside the victim; the switch has
    ``nodes + 2`` ports (victim, co-runners, memory).  ``way_mask``
    (victim LLC allocation mask, ``None`` = unpartitioned) is the QoS
    knob under test."""
    nodes: int = 1
    link_latency: int = 4
    victim_gap: int = 2
    corunner_gap: int = 1
    bundle_cycles: int = 64
    passes: int = 2
    way_mask: int | None = None
    wss: str = "llc"

    def __post_init__(self):
        if self.nodes < 0:
            raise ValueError(f"nodes must be >= 0, got {self.nodes}")
        if self.victim_gap < 1 or self.corunner_gap < 1:
            raise ValueError("injection gaps must be >= 1 cycle")
        if self.passes < 1:
            raise ValueError(f"passes must be >= 1, got {self.passes}")


@dataclasses.dataclass(frozen=True)
class FarmResult:
    """Per-victim-request latency decomposition, request order == the
    victim's chunk order.  ``total = noc + memory`` elementwise."""
    noc_latency: np.ndarray      # (R,) int64 switch queueing + link
    mem_latency: np.ndarray      # (R,) int64 LLC/DRAM service cycles
    total_latency: np.ndarray    # (R,) int64
    metrics: LaneMetrics         # the lane's aggregate memory record
    noc: NoCResult               # the full switch delivery log
    requests: int                # victim requests (all passes)
    passes: int

    def steady(self) -> np.ndarray:
        """Total latencies of the final victim pass — the steady-state
        (warmed-LLC) distribution the QoS suite summarizes."""
        per_pass = self.requests // self.passes
        return self.total_latency[self.requests - per_pass:]


def victim_window(backend: str = "nvdla", *, max_bursts: int = 4096,
                  chunk_bursts: int = 16) -> list:
    """The victim node's DBB window from either trace compiler — the
    NVDLA register-level stream or the NPU systolic-array stream, both
    chunk-aligned so one chunk is one farm request."""
    if backend == "nvdla":
        from repro_torch.core import traces

        return traces.default_dbb_window(max_bursts=max_bursts,
                                         chunk_bursts=chunk_bursts)
    if backend == "npu":
        from repro_torch.core import npu

        return npu.default_npu_window(max_bursts=max_bursts,
                                      chunk_bursts=chunk_bursts)
    raise ValueError(f"unknown victim backend {backend!r} "
                     "(expected 'nvdla' or 'npu')")


def farm_schedule(requests: int, farm: FarmConfig) -> np.ndarray:
    """The switch injection schedule: (T, nodes + 2) egress indices,
    -1 for no-flit cycles.  Victim = port 0, co-runners = ports
    1..nodes, memory egress = port nodes + 1.  The victim injects its
    ``requests`` flits every ``victim_gap`` cycles; each co-runner
    injects every ``corunner_gap`` cycles across that whole window."""
    ports = farm.nodes + 2
    mem = ports - 1
    horizon = max(1, requests * farm.victim_gap)
    dests = np.full((horizon, ports), -1, np.int64)
    dests[np.arange(requests) * farm.victim_gap, 0] = mem
    for w in range(farm.nodes):
        dests[np.arange(0, horizon, farm.corunner_gap), 1 + w] = mem
    return dests


def simulate_farm(nvdla_segs: list | None = None, *, llc: LLCConfig,
                  dram, farm: FarmConfig | None = None,
                  chunk_bursts: int = 16, t_llc_hit: int = 20,
                  backend: str = "nvdla", max_bursts: int = 2048,
                  device=None) -> FarmResult:
    """One farm simulation: victim requests through the NoC switch and
    the shared memory system, composed into per-request latencies.

    ``nvdla_segs`` is ONE victim pass (defaults to the chosen
    ``backend``'s window clipped to ``max_bursts``); the lane replays
    it ``farm.passes`` times so later passes see the LLC the earlier
    ones warmed.  The memory lane's co-runner count equals the farm's
    node count — the same cores contend on both the switch and the
    cache."""
    farm = farm or FarmConfig()
    if nvdla_segs is None:
        nvdla_segs = victim_window(backend, max_bursts=max_bursts,
                                   chunk_bursts=chunk_bursts)
    lane_segs = list(nvdla_segs) * farm.passes
    mix = MixConfig(corunners=farm.nodes,
                    wss=farm.wss if farm.nodes else "l1")
    mem_lat, metrics = lane_request_latencies(
        lane_segs, llc=llc, dram=dram, mix=mix,
        chunk_bursts=chunk_bursts, t_llc_hit=t_llc_hit,
        way_mask=farm.way_mask, device=device)
    requests = int(mem_lat.shape[0])
    sched = farm_schedule(requests, farm)
    switch = NoCSwitch(NoCConfig(ports=farm.nodes + 2,
                                 link_latency=farm.link_latency),
                       device=device)
    noc = switch.simulate(sched, bundle_cycles=farm.bundle_cycles)
    noc_lat = noc.source_latencies(0)
    if noc_lat.shape[0] != requests:
        raise RuntimeError(
            f"switch delivered {noc_lat.shape[0]} victim flits for "
            f"{requests} requests — schedule/lane mismatch")
    mem_lat = np.asarray(mem_lat, np.int64)
    return FarmResult(noc_latency=noc_lat, mem_latency=mem_lat,
                      total_latency=noc_lat + mem_lat, metrics=metrics,
                      noc=noc, requests=requests, passes=farm.passes)

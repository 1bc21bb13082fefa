"""Shared-memory interference: BwWrite co-runners vs NVDLA (paper sec 4.2).

BwWrite [Valsan et al., RTAS'16] writes sequentially through a working
set sized to land in a chosen level of the hierarchy.  Its effect on the
accelerator depends on where the WSS lands:

* **L1-fitting**  — cores never touch the shared fabric: no interference.
* **LLC-fitting** — co-runners occupy LLC bandwidth and evict the
  accelerator's freshly-filled blocks between its 32 B bursts:
  shared-bus queueing + an eviction probability that grows with the
  number of writers.
* **DRAM-fitting** — co-runners miss the LLC entirely: the accelerator
  loses DRAM bandwidth share and its row-buffer locality (FR-FCFS queue
  mixing raises effective latency).

Each co-runner case maps to a perturbed ``MemSystemConfig``; the
parameters below are calibrated once against Fig. 6's endpoints (2.1x /
2.5x at 4 co-runners) and produce the full curves in the benchmark.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.accelerator import MemSystemConfig

# calibrated interference coefficients (see module docstring)
LLC_EVICT_PER_CORE = 0.15       # eviction probability added per writer
LLC_BUS_DELAY_PER_CORE = 24.0   # cycles of shared-bus queueing per writer
DRAM_LAT_PER_CORE = 0.09        # fractional DRAM latency growth per writer
DRAM_BW_PER_CORE = 0.14        # fraction of DRAM bandwidth taken per writer


def with_corunners(mem: MemSystemConfig, n: int, wss: str
                   ) -> MemSystemConfig:
    """Perturb the memory system for `n` BwWrite co-runners with working
    set `wss` in {"l1", "llc", "dram"}."""
    if n == 0 or wss == "l1":
        return mem
    if wss == "llc":
        return dataclasses.replace(
            mem,
            llc_eviction_prob=min(0.85, n * LLC_EVICT_PER_CORE),
            bus_delay_cycles=n * LLC_BUS_DELAY_PER_CORE,
        )
    if wss == "dram":
        # DRAM-fitting writers also sweep the LLC on their way out
        return dataclasses.replace(
            mem,
            llc_eviction_prob=min(0.9, n * LLC_EVICT_PER_CORE),
            bus_delay_cycles=n * LLC_BUS_DELAY_PER_CORE,
            extra_dram_latency=mem.t_dram_cycles * n * DRAM_LAT_PER_CORE,
            dram_bw_share=max(0.2, 1.0 - n * DRAM_BW_PER_CORE),
        )
    raise ValueError(f"unknown wss {wss!r}")

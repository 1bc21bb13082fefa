"""DRAM configuration: banks, open rows, FR-FCFS-style row-hit priority.

Matches the FireSim memory-model knobs the paper uses (DDR3, 4 ranks x 8
banks, FR-FCFS).  The accelerator timing model reads the peak bandwidth
from here; the per-access row model comes with the DRAM/socsim slice of
the port.
"""
from __future__ import annotations

import dataclasses


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

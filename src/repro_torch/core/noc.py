"""Cycle-token NoC switch: FireSim's token-routed switch model in PyTorch.

FireSim simulates distributed targets by exchanging *tokens* — one per
target cycle per link — through a software switch
(``target-design/switch/switch.cc``): each port has ingress/egress
queues, links have a fixed latency in target cycles, and the switch
arbitrates deterministically, so an N-node simulation is cycle-exact
and bit-reproducible regardless of host scheduling.  This module is
that switch for the paper's SoC farm (``repro_torch.core.farm``): N
nodes' DBB request flits contend for a shared memory port, and the
per-flit latency distribution is the interconnect half of the
tail-latency story (the LLC/DRAM half comes from the segment engine).

Model, per target cycle (identical in both implementations):

1. **inject** — ``dests[c, p] >= 0`` appends a flit ``(inject=c,
   dst=dests[c, p])`` to ingress FIFO ``p``.  A full FIFO sets the
   overflow flag (the driver raises; the default depth provably cannot
   overflow).
2. **arbitrate** — each egress port grants among the *cycle-start*
   ingress FIFO heads whose flit has traversed the input link
   (``inject + link_latency <= c``) and targets it, picking the first
   in round-robin order from its pointer; every egress moves at most
   one flit per cycle (the bandwidth token).  Heads are snapshotted
   before any pop, and an ingress head targets exactly one egress, so
   simultaneous grants never conflict.
3. **deliver** — a granted flit pops, records latency ``c - inject``
   (queueing + link), and advances its egress's round-robin pointer
   past the granted ingress.

Two implementations, bit-identical for every bundle size
(tests/test_torch_noc.py, against the reference package's too):

* ``simulate_reference`` — a plain-Python per-cycle loop, the
  semantics oracle;
* ``NoCSwitch.simulate`` — the same cycle function executed in FAME-1
  *token bundles* of ``bundle_cycles`` target cycles, leaving at the
  first bundle boundary after every flit has delivered
  (``kernels.noc.ops.switch``): on ``cuda`` the whole loop is one launch
  of the hand-written ``noc_switch`` kernel (``csrc/noc.cu``: up to 32
  ports a warp a switch and a lane a port, more a block a switch and a
  thread a port), at any port count; on the CPU the plain version runs the
  cycle as a torch step over FIFO state through ``fame1.chunked_scan``,
  one host step a bundle.  Bundle padding cycles are clock-gated no-ops,
  so results are invariant to the bundle size — including bundles that
  do not divide the cycle count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.noc import ops as noc_ops
from repro_torch.utils.env import default_device


@dataclasses.dataclass(frozen=True)
class NoCConfig:
    """Switch geometry and link timing, all in target cycles.

    ``queue_depth=None`` sizes every ingress FIFO to the schedule's
    per-port flit total — deep enough that overflow is impossible, the
    FireSim switch's "infinite input buffer" configuration.  A concrete
    depth models finite buffering: the simulation then reports overflow
    instead of silently dropping flits."""
    ports: int = 5
    link_latency: int = 4
    queue_depth: int | None = None

    def __post_init__(self):
        if self.ports < 1:
            raise ValueError(f"ports must be >= 1, got {self.ports}")
        if self.link_latency < 0:
            raise ValueError("link_latency must be >= 0, got "
                             f"{self.link_latency}")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1 (or None), got "
                             f"{self.queue_depth}")


@dataclasses.dataclass(frozen=True)
class NoCResult:
    """Flattened delivery log, one row per delivered flit in
    (deliver_cycle, egress) order — deterministic, so two simulations
    agree iff their arrays are element-wise equal."""
    deliver_cycle: np.ndarray    # (F,) int64
    egress: np.ndarray          # (F,) int64 egress port
    src: np.ndarray             # (F,) int64 ingress port
    latency: np.ndarray         # (F,) int64  deliver - inject
    cycles_run: int             # target cycles actually simulated
    host_steps: int | None = None   # bundles executed (None: reference)

    @property
    def inject_cycle(self) -> np.ndarray:
        return self.deliver_cycle - self.latency

    def source_latencies(self, port: int) -> np.ndarray:
        """Latencies of port ``port``'s flits in injection order (a
        single-egress source delivers in FIFO order, so deliver order
        == inject order — the farm driver's per-request view)."""
        mine = self.src == port
        order = np.argsort(self.inject_cycle[mine], kind="stable")
        return self.latency[mine][order]


class NoCOverflowError(RuntimeError):
    """An ingress FIFO exceeded ``queue_depth`` — finite buffering
    dropped a flit, so latencies past that point are meaningless."""


def _schedule_params(dests: np.ndarray, cfg: NoCConfig
                     ) -> tuple[int, int, int]:
    """(total_flits, horizon, depth) for an injection schedule.  The
    horizon bounds the drain time: every egress moves >= 1 eligible
    flit per cycle, so all F flits deliver within
    T + F + link_latency cycles of the last injection opportunity."""
    if dests.ndim != 2 or dests.shape[1] != cfg.ports:
        raise ValueError(f"dests must be (T, {cfg.ports}), got "
                         f"{dests.shape}")
    if np.any(dests >= cfg.ports):
        raise ValueError("dests entries must be < ports (or negative "
                         "for no-flit cycles)")
    total = int((dests >= 0).sum())
    horizon = dests.shape[0] + total + cfg.link_latency + 1
    depth = (cfg.queue_depth if cfg.queue_depth is not None
             else max(1, int((dests >= 0).sum(axis=0).max(initial=1))))
    return total, horizon, depth


def switch_args(dests, cfg: NoCConfig) -> tuple[torch.Tensor, dict]:
    """The switch op's operands for an injection schedule, as
    ``NoCSwitch.simulate`` hands them to ``kernels.noc.ops.switch``:
    (dests (T, ports) int32 on the CPU, every negative entry -1; the
    op's ``link`` / ``depth`` / ``total`` / ``h_pad`` keywords).
    ``h_pad`` is the horizon padded to a power of two (padding rows
    inject nothing), as the reference buckets its compiled programs."""
    dests = np.asarray(dests, np.int64)
    total, horizon, depth = _schedule_params(dests, cfg)
    return (torch.as_tensor(np.where(dests >= 0, dests, -1).astype(np.int32)),
            dict(link=cfg.link_latency, depth=depth, total=total,
                 h_pad=1 << max(0, horizon - 1).bit_length()))


def simulate_reference(dests, cfg: NoCConfig) -> NoCResult:
    """The per-cycle reference scheduler: one plain-Python iteration
    per target cycle, no batching — the oracle the token-bundle
    implementation must match bit for bit."""
    dests = np.asarray(dests, np.int64)
    total, horizon, depth = _schedule_params(dests, cfg)
    ports, link = cfg.ports, cfg.link_latency
    queues: list[list[tuple[int, int]]] = [[] for _ in range(ports)]
    rr = [0] * ports
    rows: list[tuple[int, int, int, int]] = []
    delivered = 0
    c = 0
    while delivered < total and c < horizon:
        if c < dests.shape[0]:
            for p in range(ports):
                d = int(dests[c, p])
                if d >= 0:
                    if len(queues[p]) >= depth:
                        raise NoCOverflowError(
                            f"ingress FIFO {p} overflowed depth {depth} "
                            f"at cycle {c}")
                    queues[p].append((c, d))
        # arbitrate against the cycle-start head snapshot, then pop
        grants: list[tuple[int, int]] = []
        for e in range(ports):
            for k in range(ports):
                p = (rr[e] + k) % ports
                q = queues[p]
                if q and q[0][1] == e and q[0][0] + link <= c:
                    grants.append((e, p))
                    break
        for e, p in grants:
            inj, _ = queues[p].pop(0)
            rows.append((c, e, p, c - inj))
            rr[e] = (p + 1) % ports
            delivered += 1
        c += 1
    arr = np.asarray(rows, np.int64).reshape(-1, 4)
    return NoCResult(deliver_cycle=arr[:, 0], egress=arr[:, 1],
                     src=arr[:, 2], latency=arr[:, 3], cycles_run=c)


class NoCSwitch:
    """The token-bundle switch: ``simulate`` runs the whole farm's
    injection schedule on ``device`` (``cuda`` when None: one kernel
    launch), k target cycles a bundle."""

    def __init__(self, cfg: NoCConfig | None = None, *, device=None):
        self.cfg = cfg or NoCConfig()
        self.device = default_device(device)

    def simulate(self, dests, *, bundle_cycles: int = 64) -> NoCResult:
        """``dests`` (T, ports) int: entry (c, p) is the egress port of
        the flit port p injects at cycle c, or -1 for none.  Returns
        the delivery log; raises ``NoCOverflowError`` if a finite
        ``queue_depth`` dropped a flit."""
        dests, kw = switch_args(dests, self.cfg)
        bundle = int(bundle_cycles)
        if bundle < 1:
            raise ValueError(f"bundle_cycles must be >= 1, got {bundle}")
        run = noc_ops.switch(dests.to(self.device), bundle=bundle, **kw)
        if run.overflow:
            raise NoCOverflowError(
                f"an ingress FIFO overflowed depth {kw['depth']}; deepen "
                "queue_depth or thin the injection schedule")
        if run.delivered != kw["total"]:
            raise RuntimeError(
                f"switch delivered {run.delivered}/{kw['total']} flits "
                f"within the {kw['h_pad']}-cycle horizon — scheduler "
                "invariant broken")
        cyc_i, egr_i = np.nonzero(run.granted.numpy())  # cycle-major
        return NoCResult(
            deliver_cycle=cyc_i.astype(np.int64),
            egress=egr_i.astype(np.int64),
            src=run.src.numpy()[cyc_i, egr_i].astype(np.int64),
            latency=run.lat.numpy()[cyc_i, egr_i].astype(np.int64),
            cycles_run=int(min(run.bundles * bundle, kw["h_pad"])),
            host_steps=int(run.bundles))

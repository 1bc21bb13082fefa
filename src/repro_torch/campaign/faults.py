"""Deterministic fault injection for campaign runs.

The executor's crash-safety claims are only worth what the tests can
prove, and the tests can only prove what they can *inject*.  This
module wraps the executor's ``PointHooks`` seam with a scheduled fault
plan:

* ``crash``  — raise ``InjectedCrash`` (a ``BaseException``, so the
  executor's retry logic cannot swallow it) before the point runs:
  the simulated hard kill of a worker process;
* ``hang``   — sleep past the per-point timeout inside the worker:
  a wedged simulation that must be timed out and retried;
* ``nan``    — poison a float field of an otherwise-complete result:
  the classic silently-diverged lane the guardrails must catch;
* ``corrupt``— deflate the hit counters *consistently* (total recomputed
  so the closed-form identity still holds): only the cross-point
  LRU-inclusion monotonicity guardrail can catch this one;
* ``torn``   — after the point's journal record is appended, truncate
  the journal mid-record and crash: the torn-write the checksummed
  replay must detect and re-enqueue.

Every fault fires exactly once: firings are journaled (append + fsync)
to ``faults_consumed.jsonl`` in the campaign directory *before* the
fault takes effect, so a resumed run — a fresh "process" — does not
re-fire faults it already delivered.  That makes a faulted campaign a
deterministic function of (spec, plan): the equivalence tests demand
the final manifest be bit-identical to a clean run's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time

from repro_torch.campaign.executor import PointHooks
from repro_torch.campaign.manifest import Journal
from repro_torch.campaign.spec import CampaignSpec

FAULT_KINDS = ("crash", "hang", "nan", "corrupt", "torn")


class InjectedCrash(BaseException):
    """Simulated process death.  Derives from ``BaseException`` so no
    retry/quarantine path can absorb it — exactly like a SIGKILL."""


@dataclasses.dataclass(frozen=True)
class Fault:
    point_id: str
    kind: str
    attempt: int = 0          # fire on this attempt number only
    hang_s: float = 1.0       # sleep length for "hang"
    field: str = "hit_rate"   # poisoned field for "nan"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {FAULT_KINDS}")

    @property
    def key(self) -> str:
        return f"{self.point_id}:{self.kind}:{self.attempt}"


def plan_from_indices(spec: CampaignSpec,
                      entries: list[dict]) -> list[Fault]:
    """Build a fault plan from spec-order point indices — the JSON shape
    the CLI's ``--inject`` file uses: ``[{"point": 3, "kind": "crash",
    "attempt": 0, ...}, ...]``."""
    points = spec.expand()
    faults = []
    for e in entries:
        idx = e["point"]
        if not 0 <= idx < len(points):
            raise ValueError(f"fault point index {idx} outside the "
                             f"{len(points)}-point campaign")
        faults.append(Fault(
            point_id=points[idx].point_id, kind=e["kind"],
            attempt=int(e.get("attempt", 0)),
            hang_s=float(e.get("hang_s", 1.0)),
            field=str(e.get("field", "hit_rate"))))
    return faults


def _consistent_deflate(result, dram_cfg):
    """Zero the hit counters of a ``LaneMetrics`` but keep the
    closed-form latency identity intact (every access a miss, every
    miss a row miss) — internally consistent, globally wrong: only the
    cross-point monotonicity guardrail can catch it."""
    acc = result.accesses
    return dataclasses.replace(
        result,
        llc_hits=0,
        dram_row_hits=0,
        hit_rate=0.0,
        nvdla_hits=0,
        nvdla_hit_rate=0.0,
        nvdla_misses=result.nvdla_accesses,
        nvdla_miss_row_hits=0,
        nvdla_miss_row_hit_rate=0.0,
        total_cycles=(acc * result.t_llc_hit + acc * dram_cfg.t_cas_cycles
                      + acc * (dram_cfg.t_rp_cycles
                               + dram_cfg.t_rcd_cycles)))


class FaultInjector(PointHooks):
    """PointHooks implementation driven by a deterministic fault plan.

    ``consumed_path`` (default ``<out_dir>/faults_consumed.jsonl``)
    records delivered faults durably before they take effect; pass the
    same plan to every resume attempt and each fault still fires once
    across the whole campaign lifetime."""

    def __init__(self, faults: list[Fault], out_dir: str, *,
                 consumed_name: str = "faults_consumed.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.faults = list(faults)
        self.path = os.path.join(out_dir, consumed_name)
        self._consumed: set[str] = set()
        if os.path.exists(self.path):
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            self._consumed.add(json.loads(line)["key"])
                        except (json.JSONDecodeError, KeyError):
                            continue   # torn tail of the consumed log

    def _due(self, point, attempt: int | None, kinds: tuple[str, ...]):
        """Next unconsumed fault for this (point, attempt, kind set);
        ``attempt=None`` matches any attempt."""
        for fault in self.faults:
            if (fault.point_id == point.point_id
                    and (attempt is None or fault.attempt == attempt)
                    and fault.kind in kinds
                    and fault.key not in self._consumed):
                return fault
        return None

    def _consume(self, fault: Fault) -> None:
        """Durably mark a fault delivered *before* it takes effect —
        the injector survives its own crashes the same way the
        executor does."""
        self._consumed.add(fault.key)
        with open(self.path, "a") as f:
            f.write(json.dumps({"key": fault.key}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- PointHooks ------------------------------------------------------
    def before_point(self, point, attempt: int) -> None:
        fault = self._due(point, attempt, ("crash",))
        if fault is not None:
            self._consume(fault)
            raise InjectedCrash(f"injected crash before point "
                                f"{point.point_id} attempt {attempt}")

    def in_worker(self, point, attempt: int, run):
        fault = self._due(point, attempt, ("hang",))
        if fault is not None:
            self._consume(fault)
            time.sleep(fault.hang_s)
        result = run()
        fault = self._due(point, attempt, ("nan",))
        if fault is not None:
            self._consume(fault)
            result = dataclasses.replace(result,
                                         **{fault.field: math.nan})
        fault = self._due(point, attempt, ("corrupt",))
        if fault is not None:
            self._consume(fault)
            result = _consistent_deflate(result, point.dram.dram())
        return result

    def after_append(self, point, journal: Journal) -> None:
        fault = self._due(point, None, ("torn",))
        if fault is not None:
            self._consume(fault)
            size = os.path.getsize(journal.path)
            with open(journal.path, "rb+") as f:
                f.truncate(max(0, size - 17))   # tear into the record
            raise InjectedCrash(f"injected torn write after point "
                                f"{point.point_id}")

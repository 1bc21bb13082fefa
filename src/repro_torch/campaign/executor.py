"""Fault-tolerant campaign executor: the run farm for simulated SoCs.

Turns a ``CampaignSpec`` into completed, journaled sweep points the way
FireSim's run-farm manager turns a fleet config into completed FPGA
runs — assuming from the start that workers crash, hang, and return
garbage:

* **sharding** — pending points are grouped into *lane buckets*: points
  sharing (model, mix, DRAM) share one compressed DBB trace, built once
  per bucket, and their geometries are ordered by
  ``repro_torch.core.sweep.lane_buckets`` so similar set counts share
  one replay;
* **batching** — each bucket runs as ONE lane-batched replay
  (``sweep.interference_lane_metrics_batch``) on ``device``, optionally
  sharded over a device mesh
  (``repro_torch.launch.mesh.make_sweep_mesh``) so a point batch
  spreads across devices like a FireSim run farm spreads simulations
  across FPGAs.  Batch results are unstacked back into
  per-point journal records — bit-identical to the sequential path —
  and fault handling stays per-point: a point whose attempt fails
  (injected fault, guardrail trip) is retried through the sequential
  path, so quarantine granularity is unchanged;
* **journaling** — every completed point is appended to the campaign's
  checksummed JSONL journal *before* the executor moves on (see
  ``repro_torch.campaign.manifest``); a kill at any instant loses at
  most the in-flight point;
* **resume** — ``resume=True`` replays the journal, drops torn/corrupt
  records by checksum, re-validates every surviving result against the
  closed-form invariants, and re-enqueues exactly the missing points;
* **robustness** — each point runs under an optional wall-clock timeout
  and bounded retry with exponential backoff; results must pass the
  numeric guardrails (finite floats, hits <= accesses, the closed-form
  latency identity, and LRU-inclusion monotonicity of hit counts in
  ways across constant-``sets`` geometry families) or the point is
  retried and, when retries are exhausted, quarantined into the
  manifest's ``failed_points`` section instead of aborting the campaign.

The final ``manifest.json`` is a pure function of (spec, results): a
campaign that survived injected crashes/hangs/NaNs/torn writes ends
bit-identical to an uninterrupted one, and to the reference package's
manifest for the same spec.

Every lane call builds its tensors inside the call, so the work a
timed-out attempt's thread still has in flight shares no tensor with
the retry.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import time

from repro_torch.campaign.manifest import (
    JOURNAL_NAME,
    MANIFEST_NAME,
    Journal,
    JournalError,
    atomic_write_json,
    build_manifest,
)
from repro_torch.campaign.spec import (
    CampaignPoint,
    CampaignSpec,
    canonical_json,
)
from repro_torch.core.socsim import (
    PipelineInvariantError,
    check_segment_totals,
    check_segment_totals_batch,
)
from repro_torch.core.sweep import LaneMetrics
from repro_torch.utils.env import default_device


class GuardrailViolation(RuntimeError):
    """A point's result failed numeric validation — treated like any
    other point failure: retried, then quarantined."""


class PointTimeout(RuntimeError):
    """A point exceeded the per-point wall-clock budget."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-point failure handling: ``max_retries`` *re*-tries after the
    first attempt, exponential backoff between attempts, optional
    wall-clock timeout per attempt (None = unbounded)."""
    max_retries: int = 2
    timeout_s: float | None = None
    backoff_s: float = 0.05
    backoff_factor: float = 2.0

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * self.backoff_factor ** attempt


class PointHooks:
    """Instrumentation seams the fault injector (and tests) plug into.
    The default implementation is a no-op executor pass-through."""

    def before_point(self, point: CampaignPoint, attempt: int) -> None:
        """Called in the main thread before an attempt is dispatched."""

    def in_worker(self, point: CampaignPoint, attempt: int, run):
        """Called inside the (possibly timed) worker; must return the
        result of ``run()`` — or a corrupted stand-in, if injecting."""
        return run()

    def after_append(self, point: CampaignPoint, journal: Journal) -> None:
        """Called after the point's journal record is durably appended."""


@dataclasses.dataclass
class CampaignResult:
    manifest: dict
    manifest_path: str
    executed: int          # points actually run this invocation
    resumed: int           # points restored from the journal
    dropped_records: int   # torn/corrupt journal lines discarded
    failed: dict           # point_id -> failure info

    @property
    def completed(self) -> int:
        return self.manifest["counts"]["completed"]


def run_point(point: CampaignPoint, nvdla_segs: list, *,
              device=None) -> LaneMetrics:
    """Execute one sweep point: the co-runner-interleaved lane through
    the exact segment LLC engine + closed-form DRAM row model on
    ``device`` (``cuda`` when None).  Returns the typed ``LaneMetrics``
    record."""
    from repro_torch.core.sweep import interference_lane_metrics

    return interference_lane_metrics(
        nvdla_segs, llc=point.geometry.llc(), dram=point.dram.dram(),
        mix=point.mix.mix(), chunk_bursts=point.model.chunk_bursts,
        device=device)


def run_batch(points: list[CampaignPoint], nvdla_segs: list,
              mesh=None, *, device=None) -> list[LaneMetrics]:
    """Execute a batch of points sharing one trace as lane-batched
    replays on ``device``, or sharded over ``mesh``'s devices.  Every
    returned ``LaneMetrics`` is bit-identical to ``run_point`` for that
    point; raises (e.g. unsupported stride) mean the caller should fall
    back to the sequential path."""
    from repro_torch.core.sweep import interference_lane_metrics_batch

    chunk_bursts = {p.model.chunk_bursts for p in points}
    if len(chunk_bursts) != 1:
        raise ValueError("batch mixes chunk_bursts values; shard first")
    return interference_lane_metrics_batch(
        nvdla_segs,
        llcs=[p.geometry.llc() for p in points],
        drams=[p.dram.dram() for p in points],
        mixes=[p.mix.mix() for p in points],
        chunk_bursts=chunk_bursts.pop(), mesh=mesh, device=device)


def _monotone_family_key(point: CampaignPoint) -> tuple | None:
    """Family under which LRU inclusion makes hit counts monotone in
    ways: identical trace (solo lanes only — co-runner traces depend on
    the LLC size) and identical (sets, block).  None = not comparable."""
    if point.mix.corunners and point.mix.wss != "l1":
        return None
    llc = point.geometry.llc()
    return (canonical_json(point.model.to_dict()),
            canonical_json(point.dram.to_dict()),
            llc.sets, llc.block_bytes)


def validate_result(point: CampaignPoint, result: LaneMetrics,
                    families: dict) -> None:
    """Numeric guardrails for one typed ``LaneMetrics`` result.  Raises
    ``GuardrailViolation`` naming the failed invariant; checks run
    *before* journaling, so a poisoned number never becomes durable.
    Field *types* are still checked — the fault injector (and a
    corrupted journal) can smuggle NaN into a counter field that the
    dataclass type hints merely promise is an int."""
    import math

    for k in LaneMetrics._INT_FIELDS:
        v = getattr(result, k)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise GuardrailViolation(
                f"{point.point_id}: field {k!r} must be a nonnegative "
                f"int, got {v!r}")
    for k in LaneMetrics._FLOAT_FIELDS:
        v = getattr(result, k)
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            raise GuardrailViolation(
                f"{point.point_id}: field {k!r} must be finite, got {v!r}")
    try:
        check_segment_totals(
            accesses=result.accesses, llc_hits=result.llc_hits,
            dram_row_hits=result.dram_row_hits,
            total_cycles=result.total_cycles,
            dram=point.dram.dram(), t_llc_hit=result.t_llc_hit)
    except PipelineInvariantError as e:
        raise GuardrailViolation(f"{point.point_id}: {e}") from e
    if result.nvdla_hits > result.nvdla_accesses:
        raise GuardrailViolation(
            f"{point.point_id}: nvdla_hits {result.nvdla_hits} exceeds "
            f"nvdla_accesses {result.nvdla_accesses}")
    if result.nvdla_hits > result.llc_hits:
        raise GuardrailViolation(
            f"{point.point_id}: nvdla_hits {result.nvdla_hits} exceeds "
            f"whole-lane llc_hits {result.llc_hits} — NVDLA hits are a "
            "subset of the lane's hits")
    key = _monotone_family_key(point)
    if key is None:
        return
    ways = point.geometry.llc().ways
    hits = result.llc_hits
    for other_ways, (other_id, other_hits) in families.get(key, {}).items():
        if ((other_ways <= ways and other_hits > hits)
                or (other_ways >= ways and other_hits < hits)):
            raise GuardrailViolation(
                f"{point.point_id}: llc_hits {hits} at ways={ways} breaks "
                f"LRU inclusion against point {other_id} "
                f"(llc_hits {other_hits} at ways={other_ways}) — "
                "hit counts must be monotone in ways at fixed sets/block")


def _record_family(point: CampaignPoint, result: LaneMetrics,
                   families: dict) -> None:
    key = _monotone_family_key(point)
    if key is not None:
        families.setdefault(key, {})[point.geometry.llc().ways] = (
            point.point_id, result.llc_hits)


def shard_points(points: list[CampaignPoint]) -> list[list[CampaignPoint]]:
    """Deterministic lane-bucket sharding: group points sharing a trace
    (model — mixes and DRAM configs are per-lane operands of the batch
    replay, so they ride along in one shard), then order each group's
    geometries with ``sweep.lane_buckets`` so similar set counts run
    back to back and share one replay.  Wide shards matter on a mesh:
    every extra shard is another narrow per-device replay whose fixed
    per-round cost is pure overhead."""
    from repro_torch.core.sweep import lane_buckets

    groups: dict[str, list[CampaignPoint]] = {}
    for p in points:
        key = str(p.model.to_dict())
        groups.setdefault(key, []).append(p)
    shards = []
    for group in groups.values():
        cfgs = [p.geometry.llc() for p in group]
        for bucket in lane_buckets(cfgs):
            shards.append([group[i] for i in bucket])
    return shards


def _attempt(point: CampaignPoint, attempt: int, nvdla_segs: list,
             hooks: PointHooks, policy: RetryPolicy,
             compute=None, *, device=None) -> LaneMetrics:
    """One timed attempt at one point.  ``compute`` overrides the
    simulation callable — the batch scheduler passes a closure over the
    point's precomputed batch result, so hooks (fault injection, hangs,
    corruption) still wrap every attempt identically to the sequential
    path."""
    compute = compute or (lambda: run_point(point, nvdla_segs,
                                            device=device))

    def work():
        return hooks.in_worker(point, attempt, compute)

    if policy.timeout_s is None:
        return work()
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix=f"campaign-{point.point_id[:6]}")
    try:
        future = pool.submit(work)
        try:
            return future.result(timeout=policy.timeout_s)
        except concurrent.futures.TimeoutError:
            future.cancel()
            raise PointTimeout(
                f"{point.point_id}: attempt {attempt} exceeded "
                f"{policy.timeout_s}s") from None
    finally:
        # never block on a hung worker; the thread dies with the process
        pool.shutdown(wait=False)


def _load_journal_state(journal: Journal, spec: CampaignSpec,
                        known_ids: set[str]):
    """Replay + re-validate a journal.  Returns (completed, failed,
    dropped): corrupt lines and records for unknown points are dropped,
    and a completed record whose numbers fail the closed-form
    invariants is *demoted to pending* (dropped) rather than trusted."""
    records, dropped = journal.replay()
    completed: dict[str, dict] = {}
    failed: dict[str, dict] = {}
    points_by_id = {p.point_id: p for p in spec.expand()}
    for rec in records:
        kind = rec["kind"]
        if kind == "spec":
            if rec.get("spec_hash") != spec.spec_hash:
                raise JournalError(
                    f"journal at {journal.path} belongs to campaign "
                    f"spec {rec.get('spec_hash')}, not {spec.spec_hash} — "
                    "refusing to resume a different campaign")
        elif kind == "point":
            pid = rec.get("point_id")
            if pid not in known_ids:
                dropped += 1
                continue
            try:
                metrics = LaneMetrics.from_record(rec["result"])
                validate_result(points_by_id[pid], metrics, {})
            except (GuardrailViolation, KeyError, TypeError, ValueError):
                dropped += 1
                continue
            completed[pid] = rec["result"]
        elif kind == "failed":
            pid = rec.get("point_id")
            if pid in known_ids:
                failed[pid] = {"error": rec.get("error", ""),
                               "attempts": rec.get("attempts", 0)}
    return completed, failed, dropped


def _batch_first_attempts(chunk: list[CampaignPoint], nvdla_segs: list,
                          mesh, note, *, device=None
                          ) -> list[LaneMetrics] | None:
    """Precompute attempt-0 results for a point chunk as one
    lane-batched (optionally mesh-sharded) replay, pre-validated with the
    batched closed-form check.  Returns None — sequential fallback for
    the whole chunk — if the batch engine cannot run it (unsupported
    stride, inconsistent batch); per-point failures are impossible
    here because faults are injected downstream, in the per-point
    attempt loop."""
    try:
        results = run_batch(chunk, nvdla_segs, mesh=mesh, device=device)
        check_segment_totals_batch(
            accesses=[r.accesses for r in results],
            llc_hits=[r.llc_hits for r in results],
            dram_row_hits=[r.dram_row_hits for r in results],
            total_cycles=[r.total_cycles for r in results],
            drams=[p.dram.dram() for p in chunk],
            t_llc_hit=results[0].t_llc_hit if results else 20)
        return results
    except Exception as e:
        note(f"batch of {len(chunk)} points fell back to sequential: "
             f"{type(e).__name__}: {e}")
        return None


def run_campaign(spec: CampaignSpec, out_dir: str, *,
                 resume: bool = False, overwrite: bool = False,
                 policy: RetryPolicy | None = None,
                 hooks: PointHooks | None = None,
                 retry_failed: bool = False,
                 progress=None, mesh=None,
                 batch_points: int = 32, device=None) -> CampaignResult:
    """Run (or resume) a campaign into ``out_dir``.

    ``resume`` replays ``journal.jsonl`` and re-enqueues only
    missing/corrupt points; without it, an existing journal is an error
    unless ``overwrite`` discards it.  ``retry_failed`` also re-enqueues
    previously quarantined points.  ``hooks`` is the fault-injection /
    instrumentation seam; ``progress`` is an optional callable fed
    one-line status strings.

    ``batch_points`` caps how many points run as one lane-batched
    replay (1 = strictly sequential).  Every lane runs on ``device``
    (``cuda`` when None; it raises without a card); ``mesh`` (see
    ``repro_torch.launch.mesh.make_sweep_mesh``) names the devices
    instead: it shards each batch's lane axis across them, and
    sequential attempts run on its first device.  Batched or not,
    journals and manifests are bit-identical: batch results unstack
    into the same per-point records, attempt-0 faults still fire per
    point, and any retry runs through the sequential path.

    Raises nothing for point-level failures (they quarantine); journal
    mismatches and spec errors raise.  A ``BaseException`` escaping a
    hook (the fault injector's simulated process death) propagates —
    the journal is already consistent at every such instant.
    """
    if mesh is not None and device is not None:
        raise ValueError("pass device= or mesh=, not both: the mesh "
                         "names the campaign's devices")
    dev = mesh.devices[0] if mesh is not None else default_device(device)
    policy = policy or RetryPolicy()
    hooks = hooks or PointHooks()
    note = progress or (lambda msg: None)
    os.makedirs(out_dir, exist_ok=True)
    journal = Journal(os.path.join(out_dir, JOURNAL_NAME))
    manifest_path = os.path.join(out_dir, MANIFEST_NAME)

    points = spec.expand()
    ids = [p.point_id for p in points]
    if len(set(ids)) != len(ids):
        raise ValueError("campaign spec expands to duplicate points")
    known_ids = set(ids)

    completed: dict[str, dict] = {}
    failed: dict[str, dict] = {}
    dropped = 0
    if os.path.exists(journal.path):
        if resume:
            completed, failed, dropped = _load_journal_state(
                journal, spec, known_ids)
            if retry_failed:
                failed = {}
        elif overwrite:
            os.remove(journal.path)
            if os.path.exists(manifest_path):
                os.remove(manifest_path)
        else:
            raise JournalError(
                f"{journal.path} already exists; pass resume=True to "
                "continue it or overwrite=True to discard it")
    if not os.path.exists(journal.path):
        journal.append({"kind": "spec", "spec": spec.to_dict(),
                        "spec_hash": spec.spec_hash})

    resumed = len(completed)
    pending = [p for p in points
               if p.point_id not in completed and p.point_id not in failed]
    note(f"campaign {spec.name}: {len(points)} points, "
         f"{resumed} resumed, {len(failed)} quarantined, "
         f"{len(pending)} to run"
         + (f", {dropped} corrupt journal lines dropped" if dropped else ""))

    # seed the cross-point guardrail history from resumed results
    families: dict = {}
    by_id = {p.point_id: p for p in points}
    for pid, record in completed.items():
        _record_family(by_id[pid], LaneMetrics.from_record(record),
                       families)

    executed = 0
    step = max(1, batch_points)
    for shard in shard_points(pending):
        nvdla_segs = shard[0].model.trace()   # one trace per lane bucket
        for lo in range(0, len(shard), step):
            chunk = shard[lo:lo + step]
            batch = (None if len(chunk) < 2 and mesh is None
                     else _batch_first_attempts(chunk, nvdla_segs,
                                                mesh, note, device=dev))
            for idx, point in enumerate(chunk):
                pid = point.point_id
                last_err: Exception | None = None
                for attempt in range(policy.max_retries + 1):
                    if attempt:
                        time.sleep(policy.backoff(attempt - 1))
                    hooks.before_point(point, attempt)
                    # attempt 0 reuses the batch result; every retry
                    # recomputes sequentially so a bad batch lane can
                    # never poison a point twice
                    compute = ((lambda r=batch[idx]: r)
                               if batch is not None and attempt == 0
                               else None)
                    try:
                        result = _attempt(point, attempt, nvdla_segs,
                                          hooks, policy, compute,
                                          device=dev)
                        validate_result(point, result, families)
                    except Exception as e:
                        last_err = e
                        note(f"point {pid} attempt {attempt} failed: "
                             f"{type(e).__name__}: {e}")
                        continue
                    journal.append({"kind": "point", "point_id": pid,
                                    "attempt": attempt,
                                    "result": result.to_record()})
                    hooks.after_append(point, journal)
                    completed[pid] = result.to_record()
                    _record_family(point, result, families)
                    executed += 1
                    last_err = None
                    break
                if last_err is not None:
                    info = {"error":
                            f"{type(last_err).__name__}: {last_err}",
                            "attempts": policy.max_retries + 1}
                    journal.append({"kind": "failed", "point_id": pid,
                                    **info})
                    hooks.after_append(point, journal)
                    failed[pid] = info
                    note(f"point {pid} quarantined after "
                         f"{info['attempts']} attempts")

    journal.append({"kind": "done",
                    "completed": len(completed), "failed": len(failed)})
    manifest = build_manifest(spec, completed, failed)
    atomic_write_json(manifest_path, manifest)
    note(f"campaign {spec.name}: {len(completed)}/{len(points)} completed, "
         f"{len(failed)} quarantined -> {manifest_path}")
    return CampaignResult(manifest=manifest, manifest_path=manifest_path,
                          executed=executed, resumed=resumed,
                          dropped_records=dropped, failed=failed)

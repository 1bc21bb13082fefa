"""Journaled campaign manifests: checksummed JSONL + atomic snapshots.

Two durability layers, matching how a run farm actually fails:

* ``Journal`` — an append-only JSONL file, one self-checksummed record
  per line (``crc`` = crc32 of the record's canonical JSON without the
  ``crc`` field), flushed and fsync'd per append.  A crash can tear at
  most the final line, and ``replay`` detects exactly that: a line that
  fails to parse or whose checksum mismatches is *dropped and counted*,
  never trusted, so the executor re-enqueues the affected point instead
  of resuming from a half-written result.
* ``atomic_write_json`` — write-temp-then-fsync-then-rename for the
  final ``manifest.json`` snapshot (and any other whole-file artifact):
  readers see either the old complete file or the new complete file,
  never a prefix.

The final manifest is a pure function of (spec, completed results,
failed points) with point records in spec order — deliberately free of
wall-clock and host details so an interrupted-then-resumed campaign is
bit-identical to an uninterrupted one (the fault-injection tests
diff the bytes).
"""
from __future__ import annotations

import json
import os
import zlib

from repro_torch.campaign.spec import CampaignSpec, canonical_json

JOURNAL_NAME = "journal.jsonl"
MANIFEST_NAME = "manifest.json"

RECORD_KINDS = ("spec", "point", "failed", "done")


def record_crc(record: dict) -> int:
    """Checksum of a journal record, excluding its own ``crc`` field."""
    payload = {k: v for k, v in record.items() if k != "crc"}
    return zlib.crc32(canonical_json(payload).encode())


def fsync_dir(path: str) -> None:
    """Flush a directory entry (the rename itself) to stable storage.
    A no-op on filesystems that refuse O_RDONLY directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj, *, indent: int | None = 2) -> None:
    """Write ``obj`` as JSON such that ``path`` is always either absent,
    the previous complete file, or the new complete file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(os.path.abspath(path)))


class JournalError(RuntimeError):
    """The journal cannot be used at all (e.g. a different campaign's
    journal is already in the output directory)."""


class Journal:
    """Append-only JSONL journal with per-record checksums."""

    def __init__(self, path: str):
        self.path = path

    def append(self, record: dict, *, fsync: bool = True) -> None:
        if record.get("kind") not in RECORD_KINDS:
            raise ValueError(f"unknown journal record kind: "
                             f"{record.get('kind')!r}")
        record = dict(record)
        record["crc"] = record_crc(record)
        line = canonical_json(record) + "\n"
        with open(self.path, "a") as f:
            f.write(line)
            f.flush()
            if fsync:
                os.fsync(f.fileno())

    def replay(self) -> tuple[list[dict], int]:
        """Parse the journal, returning (valid records, dropped lines).

        Torn or corrupt lines — unparseable JSON, missing/mismatching
        ``crc``, unknown kind — are dropped and counted; everything
        that checks out is returned in append order."""
        if not os.path.exists(self.path):
            return [], 0
        records, dropped = [], 0
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    dropped += 1
                    continue
                if (not isinstance(rec, dict)
                        or rec.get("kind") not in RECORD_KINDS
                        or rec.get("crc") != record_crc(rec)):
                    dropped += 1
                    continue
                records.append(rec)
        return records, dropped


def build_manifest(spec: CampaignSpec, completed: dict[str, dict],
                   failed: dict[str, dict]) -> dict:
    """The final, deterministic campaign manifest.

    Point records appear in *spec* order regardless of execution or
    journal order; no timestamps, attempt counts, or host details enter
    — those live in the journal.  Completed-point ``result`` dicts are
    included verbatim (they round-trip exactly through JSON)."""
    points, failed_points = [], []
    for point in spec.expand():
        pid = point.point_id
        if pid in completed:
            points.append({"point_id": pid, "params": point.params(),
                           "result": completed[pid]})
        elif pid in failed:
            failed_points.append({"point_id": pid,
                                  "params": point.params(),
                                  **failed[pid]})
    return {
        "campaign": spec.name,
        "spec": spec.to_dict(),
        "spec_hash": spec.spec_hash,
        "counts": {"total": len(spec.expand()),
                   "completed": len(points),
                   "failed": len(failed_points)},
        "points": points,
        "failed_points": failed_points,
    }

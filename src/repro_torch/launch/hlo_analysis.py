"""Collective inventory + roofline terms (the reference's
``repro.launch.hlo_analysis``).

Every all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute is sized from its result and its group size, and
converted to *wire bytes per device* with ring-algorithm cost formulas.
Two sources feed the same tally:

* ``parse_collectives`` reads optimized HLO text, as the reference does
  (the same text gives the same numbers);
* ``collectives_from_trace`` reads the port's own record of a traced
  step: the functional collectives (``torch.ops._c10d_functional``)
  that DTensor issued, each with its local result's bytes and its
  process group's size (``repro_torch.launch.dryrun`` records them).
"""
from __future__ import annotations

import dataclasses
import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\(?[a-z0-9,\[\]\{\}\s/]+?\)?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    """Sum of byte sizes of every array shape in a (possibly tuple) type."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _result_bytes(type_str: str, op: str) -> int:
    """Bytes of the op *result*.  For -start tuples, the destination buffer
    is the last element; variadic collectives sum their elements."""
    shapes = _SHAPE_RE.findall(type_str)
    if not shapes:
        return 0
    if type_str.strip().startswith("(") and op in ("all-gather", "all-reduce",
                                                   "reduce-scatter"):
        # start-op tuple: (operand(s)..., results...); halves mirror, use half
        total = _shape_bytes(type_str)
        return total // 2
    return _shape_bytes(type_str)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))  # [G, N] <= [T]: G groups of N
    return default


@dataclasses.dataclass
class CollectiveStats:
    counts: dict            # op -> count
    result_bytes: dict      # op -> sum of result bytes
    wire_bytes: float       # per-device ring-cost wire bytes
    by_group_size: dict     # (op, n) -> count


def _tally(records) -> CollectiveStats:
    """(op, result bytes, group size) records -> CollectiveStats."""
    counts: dict = {}
    result_bytes: dict = {}
    by_group: dict = {}
    wire = 0.0
    for op, size, n in records:
        counts[op] = counts.get(op, 0) + 1
        result_bytes[op] = result_bytes.get(op, 0) + size
        by_group[f"{op}/{n}"] = by_group.get(f"{op}/{n}", 0) + 1
        if n <= 1:
            continue
        frac = (n - 1) / n
        if op == "all-gather":
            wire += size * frac                     # result is the full buffer
        elif op == "all-reduce":
            wire += 2.0 * size * frac
        elif op == "reduce-scatter":
            wire += size * (n - 1)                  # result is the shard
        elif op == "all-to-all":
            wire += size * frac
        elif op == "collective-permute":
            wire += size
    return CollectiveStats(counts=counts, result_bytes=result_bytes,
                           wire_bytes=wire, by_group_size=by_group)


def parse_collectives(hlo_text: str, *, n_devices: int) -> CollectiveStats:
    records = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m is None:
            continue
        type_str, op = m.group(1), m.group(2)
        if "-done" in line.split("=")[1][:40]:
            continue
        records.append((op, _result_bytes(type_str, op),
                        _group_size(line, n_devices)))
    return _tally(records)


# torch functional collectives (and DTensor's shard-dim all-to-all) ->
# the collective whose ring formula sizes them; a broadcast is costed as
# one copy of its buffer, as a permute is
FUNCOL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def collectives_from_trace(trace, *, n_devices: int) -> CollectiveStats:
    """A traced step's collectives -> CollectiveStats.  ``trace`` holds
    (functional-collective name, local result bytes, group size) records;
    a group size of 0 stands for the whole world (``n_devices``).  Names
    outside ``FUNCOL_OPS`` raise, so no collective goes uncosted."""
    records = []
    for name, size, n in trace:
        if name not in FUNCOL_OPS:
            raise ValueError(f"collective {name!r} has no cost formula")
        records.append((FUNCOL_OPS[name], size, n or n_devices))
    return _tally(records)


def roofline_terms(*, flops: float, bytes_accessed: float, wire_bytes: float,
                   peak_flops: float, hbm_bw: float, link_bw: float) -> dict:
    """The three per-device roofline terms, in seconds."""
    compute = flops / peak_flops
    memory = bytes_accessed / hbm_bw
    collective = wire_bytes / link_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "step_lower_bound_s": bound,
        "roofline_fraction": (compute / bound) if bound > 0 else 0.0,
    }

"""Finding a cell's pieces by name, and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
``load_cell`` reads ``configs/<config>.json``, ``traffic/<traffic>.json``
and ``limits/<cell>.json``, and the metrics that the cell reports: its
end-to-end metrics, and the per-layer metrics that list it (or list no
cells); each metric's reader is ``metrics/<metric>.py``.  The traffic's
``kind`` names the driver, ``drivers/<kind>.py``, whose ``run(cell)``
returns the run's record.  Adding a configuration, a mix, a metric or a
reference family therefore means adding files, never editing these.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# top-level module names that must never be loaded: the JAX reference
# package the port was made from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path


def load_module(path: Path):
    """A module from a file of the benchmark, by its path."""
    path = Path(path).resolve()
    name = "portbench_file_" + hashlib.sha256(
        str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path | None = None) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` (``root`` the
    checkout, the folder above this one, by default)."""
    root = Path(root) if root is not None else HERE.parent
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    base = root / "portbench"
    config = _json(base / "configs" / f"{w['config']}.json")
    traffic = _json(base / "traffic" / f"{w['traffic']}.json")
    limits = _json(base / "limits" / f"{workload}.json")["limits"]

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, chips=w["chips"], config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                root=root)


def reader(cell: Cell, metric: str):
    return load_module(cell.root / "portbench" / "metrics" / f"{metric}.py")


def driver(cell: Cell):
    kind = cell.traffic["kind"]
    return load_module(cell.root / "portbench" / "drivers" / f"{kind}.py")


def read_metrics(cell: Cell, record, trace: bool) -> dict:
    """The cell's metrics of this kind of run, each ``{"value", "unit"}``;
    a reader that finds nothing to read (None) leaves its metric out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell, m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules this process has loaded, compared
    by the whole top-level name (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def _plain(x):
    """Numbers JSON can hold: a non-finite float as its name."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def run_cell(cell: Cell, *, seed: int, seconds: float, traced: bool,
             device, t_start: float, fault: str | None = None
             ) -> tuple[dict, list[str]]:
    """Everything of a run after the look for cards: the driver's run,
    the check, the metrics.  Returns (the result, the lines for standard
    error, the compared numbers beside their limits last)."""
    import torch

    from portbench import correctness

    counters = [tuple(c) for m in cell.per_layer
                for c in getattr(reader(cell, m["name"]), "COUNTERS", [])]
    run = driver(cell).run(cell, seed=seed, seconds=seconds, traced=traced,
                           device=device, t_start=t_start,
                           counters=counters, fault=fault)
    correct, checks = correctness.judge(run["numbers"], cell.limits)
    correct = correct and run["failed"] == 0
    dev = torch.device(device)
    result = {"correct": correct, "attempted": len(run["steps"]),
              "failed": run["failed"],
              "metrics": read_metrics(cell, run, traced),
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu",
                         "count": cell.chips,
                         "memory_peak_bytes": run["peak_bytes"]}}
    if traced and run["trace"] is not None and run["trace"].spans:
        tr = run["trace"]
        lo, hi = tr.window()
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    walls = sorted(sum(spans) for spans in run["steps"])
    lines = ["set-up " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   run["setup_phases"].items()),
             f"window {len(walls)} steps in {run['window_s']:.3f} s, "
             f"a step {1e3 * walls[0]:.1f} / {1e3 * walls[len(walls) // 2]:.1f}"
             f" / {1e3 * walls[-1]:.1f} ms (least / median / most)"]
    lines += [f"{k} {v['value']!r} "
             f"{ {a: b for a, b in v.items() if a != 'value'} }"
             for k, v in run["numbers"].items()]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
              + ("" if v["value"] <= v["limit"] else "  FAILS")
              for k, v in checks.items()]
    return _plain(result), lines

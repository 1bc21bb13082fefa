"""A smoke-size copy of the benchmark, for the tests on the CPU.

``tiny_root(dest, config)`` copies ``BENCHMARK.json`` and this folder
into ``dest`` and adds a cell ``tiny-<config>.train``: the configuration
``<config>`` at smoke widths (two layers), 4 rows of 64 tokens, and the
smoke limits below, listed under every per-layer metric that lists a
cell of ``<config>``.  The smoke limits were set on the CPU from sound
runs, the float8 control and the planted faults at this size, as the
cells' own limits were on the card (``PERF.md``).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent

SMOKE_WIDTHS = {
    "qwen2-0.5b": dict(num_layers=2, d_model=64, num_heads=4,
                       num_kv_heads=2, head_dim=16, d_ff=128,
                       vocab_size=256),
    "mamba2-130m": dict(num_layers=2, d_model=64, vocab_size=256,
                        ssm_state=16, ssm_head_dim=32, ssm_chunk=32),
}
SMOKE_TRAFFIC = {"kind": "train", "global_batch": 4, "seq_len": 64,
                 "setup_steps": 3, "profiled_steps": 2}
# from twelve sound seeds, three of the float8 control and of each
# planted fault, at this size on the CPU, each configuration in its own
# compute dtype (largest sound reading, then the limit): qwen2-0.5b
# (bf16) 1.7e-4, 5.5e-4, 5.3e-3, 9.2e-3; mamba2-130m (float32) 1.6e-7,
# 1.6e-7, 1.0e-6, 7.1e-6
SMOKE_LIMITS = {
    "qwen2-0.5b": {"first_loss_gap": 5e-4, "later_loss_gap": 1.2e-3,
                   "grad_gap": 1e-2, "update_gap": 1.5e-2},
    "mamba2-130m": {"first_loss_gap": 1.5e-6, "later_loss_gap": 2e-5,
                    "grad_gap": 2e-5, "update_gap": 1e-4},
}


def tiny_root(dest: Path, config: str) -> tuple[Path, str]:
    """(the copy's root, the tiny cell's name)."""
    dest = Path(dest)
    shutil.copytree(HERE, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    base = dest / "portbench"
    cfg = json.loads((base / "configs" / f"{config}.json").read_text())
    cfg["model"].update(SMOKE_WIDTHS[config])
    name = f"tiny-{config}"
    cell = f"{name}.train"
    (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny.json").write_text(json.dumps(SMOKE_TRAFFIC))
    (base / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": SMOKE_LIMITS[config]}))
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "tiny", "chips": 1,
                               "why": "smoke size, for the tests"})
    config_of = {w["name"]: w["config"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if any(config_of[w] == config for w in m.get("workloads", [])):
            m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest, cell

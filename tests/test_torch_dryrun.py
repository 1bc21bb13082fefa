"""The port's dry-run end to end: cells through the real entry point
(``python -m repro_torch.launch.dryrun``) in subprocesses, since a cell
starts a placeholder process group of 256 ranks, checked as
tests/test_dryrun.py checks the reference's artifact; and the split-K
preset of grok-1-314b's decode cell against its baseline."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"arch", "shape", "mesh", "mode", "rule_overrides", "n_devices",
        "dropped_axes", "memory", "cost", "roofline", "model_flops",
        "model_flops_ratio"}


def _run(tmp_path, *args) -> None:
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", ""), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--mesh", "pod", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=400, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]


def _cell(path: pathlib.Path) -> dict:
    out = json.loads(path.read_text())
    assert "error" not in out
    assert KEYS <= set(out)
    assert out["n_devices"] == 256
    assert out["cost"]["flops"] > 0
    return out


def test_dryrun_cell_end_to_end(tmp_path):
    _run(tmp_path, "--arch", "whisper-tiny", "--shape", "decode_32k")
    out = _cell(tmp_path / "pod" / "whisper-tiny__decode_32k.json")
    r = out["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert set(r) >= {"dominant", "roofline_fraction", "collective_s"}
    assert out["memory"]["argument_bytes"] > 0
    assert out["memory"]["output_bytes"] > 0
    # whisper's 6 heads decline the 16-way model axis
    assert "('heads', 'model', 6)" in out["dropped_axes"]
    assert sum(out["cost"]["coll_counts"].values()) > 0


def test_grok_decode_preset_shards_the_cache_without_gathering_it(tmp_path):
    """int8 KV and cache_seq -> model: less argument memory a device, the
    split-K combine's all-reduces, and no collective as large as one
    layer's cache gathered over the sequence shards."""
    _run(tmp_path / "base", "--arch", "grok-1-314b", "--shape",
         "decode_32k")
    _run(tmp_path / "perf", "--perf", "--arch", "grok-1-314b", "--shape",
         "decode_32k")
    name = "grok-1-314b__decode_32k.json"
    base = _cell(tmp_path / "base" / "pod" / name)
    perf = _cell(tmp_path / "perf" / "pod" / name)
    assert perf["rule_overrides"] == {"cache_seq": ["model"]}
    assert perf["memory"]["argument_bytes"] \
        < base["memory"]["argument_bytes"]
    # grok decode_32k: 128 rows over 16 data shards, 32768 positions,
    # 8 KV heads of 128, int8: one layer's K gathered over the sequence
    one_layer_cache = 128 // 16 * 32768 * 8 * 128
    assert perf["cost"]["largest_collective"]["result_bytes"] \
        < one_layer_cache
    assert perf["cost"]["coll_counts"]["all-reduce"] \
        > base["cost"]["coll_counts"]["all-reduce"]

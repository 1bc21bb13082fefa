"""Per-phase walls of ``chip_smoke.py``, for one or more checkouts in turns.

    python scripts/phase_walls.py [--phases NAME,NAME,...] DIR [DIR ...]

Each ``DIR`` is a checkout of this repository (its own ``chip_smoke.py``
and ``src/``).  For each, in the order given (list a checkout twice to
interleave, e.g. ``old new new old``), a fresh process builds that
checkout's kernels and runs its ``chip_smoke.py`` phases named by
``--phases``, in the order given, each with its own checks and anchors:

* ``sim_path``: Fig. 5 over the whole frame, Fig. 6, the 24 interference
  lanes, one lane's latencies, the FAME-1 pipeline (walls by step);
* ``farm_path``: the SoC farms of the Fig. 6 tail and the switch's
  parity runs (walls by farm and bundle size);
* ``serve_path``: mamba2-130m serving; ``encdec_path``: whisper-tiny
  serving; ``serve_qwen2``: qwen2-0.5b serving (``serve_swa_path``);
  ``serve_recurrentgemma``: serving with rolling caches (model and
  oracle walls each);
* ``moe_path``: mixtral-8x7b serving (8 of 32 layers) and grok-1-314b's
  greedy prefill and decode steps (2 of 64 layers);
* ``int8_kv_path``: deepseek-7b's greedy decode from int8 caches;
* ``train_path`` and ``train_ssm_path``: qwen2-0.5b's and mamba2-130m's
  training steps at full width;
* ``time_llc``: the LLC kernels' card times at the main paths' shapes
  (``llc_set_walk`` on qwen2-0.5b's decode trace, ``llc_lane_scan`` on
  Fig. 5's whole frame, launches as the tree makes them);
* ``llc_wide``: the LLC kernels' card times on ``llc_cases``' 64- and
  128-way set walks and its 128 / 64 / 40-way lane batch;
* ``time_noc``: the NoC switch kernel's card time at the x4 farm's
  schedule (a tree that has the kernel).

Beside each phase it reads the SM clock (``nvidia-smi``).

Without ``--phases`` it runs ``moe_path``, ``int8_kv_path``,
``serve_recurrentgemma``, ``train_path`` and ``train_ssm_path``.  It
prints each run's walls and writes them all to
``chiprun_out/phase_walls.json``.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "PHASE_WALLS "
PHASES = ("sim_path", "farm_path", "serve_path", "encdec_path",
          "serve_qwen2", "serve_recurrentgemma", "moe_path", "int8_kv_path",
          "train_path", "train_ssm_path", "time_llc", "llc_wide", "time_noc")
LLC_KEYS = ("ms", "plain_ms", "launches", "longest_walk", "ns_per_step",
            "sm_clock_mhz")
DEFAULT_PHASES = ("moe_path", "int8_kv_path", "serve_recurrentgemma",
                  "train_path", "train_ssm_path")


def _serving(split: dict) -> dict:
    return {k: split[k] for k in ("wall_s", "model_s", "oracle_s")}


def _llc_wide(cs, dev) -> dict:
    """Card times (ms) of ``llc_cases``' set walks of 64 and 128 ways and
    its lane batch of 128 / 64 / 40 ways, through the tree's ops."""
    from repro_torch.kernels.llc import ops

    walks, lanes = cs.llc_cases(dev)
    out = {}
    for case in walks:
        if case["args"][0].shape[1] >= 64:
            out[f"set_walk {case['name']}"] = cs.queued_ms(
                lambda: ops.set_walk(*case["args"]), 10)
    for case in lanes:
        if case["kw"]["max_ways"] >= 64:
            args = (case["table"], case["rounds"], case["geo"])
            out[f"lane_scan {case['name']}"] = cs.queued_ms(
                lambda: ops.lane_scan(*args, **case["kw"]), 10)
    return out


def _phases(cs) -> dict:
    """Each of ``PHASES``: (the chip_smoke.py call, the walls to keep of
    what it returns)."""
    return {
        "sim_path": (cs.sim_path, lambda r: {"wall_s": r["wall_s"]}),
        "farm_path": (cs.farm_path, lambda r: {"wall_s": r["wall_s"]}),
        "serve_path": (cs.serve_path, lambda r: _serving(r[1])),
        "encdec_path": (cs.encdec_path,
                        lambda r: _serving(r[1]["whisper-tiny"])),
        "serve_qwen2": (lambda dev: cs.serve_swa_path(dev, "qwen2-0.5b"),
                        lambda r: _serving(r[1])),
        "serve_recurrentgemma": (
            lambda dev: cs.serve_swa_path(dev, "recurrentgemma-9b"),
            lambda r: _serving(r[1])),
        "moe_path": (cs.moe_path, lambda r: {
            "mixtral": {**_serving(r[1]["mixtral-8x7b"]),
                        "profiled_ms": {
                            k: v["wall_ms"] for k, v in
                            r[1]["mixtral-8x7b"]["profiled"].items()}},
            "grok": {k: r[1]["grok-1-314b"][k]
                     for k in ("prefill_s", "decode_step_s")}}),
        "int8_kv_path": (cs.int8_kv_path, lambda r: {
            k: r[1]["deepseek-7b-int8"][k]
            for k in ("prefill_s", "decode_step_s")}),
        "train_path": (cs.train_path, lambda r: {
            k: r[1][k] for k in ("step_wall_ms", "step_walls_ms")}),
        "train_ssm_path": (cs.train_ssm_path, lambda r: {
            k: r[1][k] for k in ("step_wall_ms", "step_walls_ms")}),
        "time_llc": (cs.time_llc, lambda r: {
            name: {k: row[k] for k in LLC_KEYS if k in row}
            for name, row in r.items()}),
        "llc_wide": (lambda dev: _llc_wide(cs, dev), lambda r: r),
        # looked up when run: an older tree's chip_smoke.py has none
        "time_noc": (lambda dev: cs.time_noc(dev), lambda r: {
            k: r[k] for k in LLC_KEYS + ("cycles_run", "bound_ms")}),
    }


def _sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0])


def _child(tree: str, names: list[str]) -> None:
    """Run the named phases of ``tree``'s chip_smoke.py and print their
    walls on one line."""
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.setup()
    phases = _phases(cs)
    out: dict = {"tree": tree}
    for name in names:
        fn, keep = phases[name]
        t0 = time.perf_counter()
        res = fn(dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_sm_clock_mhz"] = _sm_clock_mhz()
        out[name] = keep(res)
    print(TAG + json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--child":
        _child(os.path.abspath(argv[1]), argv[2].split(","))
        return 0
    names = list(DEFAULT_PHASES)
    if argv[:1] == ["--phases"] and len(argv) >= 2:
        names = [n for n in argv[1].split(",") if n]
        argv = argv[2:]
    unknown = sorted(set(names) - set(PHASES)) if names else ["(none)"]
    if not argv or unknown:
        print(__doc__ + (f"\nunknown phases: {unknown}" if argv else ""),
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    for i, tree in enumerate(argv):
        tree = os.path.abspath(tree)
        log = out_dir / f"phase_walls_{i}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", tree, ",".join(names)],
                stdout=f, stderr=subprocess.STDOUT, timeout=1800)
        lines = [ln for ln in log.read_text().splitlines()
                 if ln.startswith(TAG)]
        if proc.returncode != 0 or not lines:
            print(f"run {i} ({tree}) failed, exit {proc.returncode}; see "
                  f"{log}", flush=True)
            print(log.read_text()[-4000:], flush=True)
            return 1
        run = json.loads(lines[-1][len(TAG):])
        run["process_s"] = time.perf_counter() - t0
        runs.append(run)
        print(f"run {i}: {tree}\n  {json.dumps(run)}", flush=True)
    (out_dir / "phase_walls.json").write_text(json.dumps(
        {"card": smi, "phases": names, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

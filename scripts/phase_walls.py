"""Per-phase walls of ``chip_smoke.py``, for one or more checkouts in turns.

    python scripts/phase_walls.py DIR [DIR ...]

Each ``DIR`` is a checkout of this repository (its own ``chip_smoke.py``
and ``src/``).  For each, in the order given (list a checkout twice to
interleave, e.g. ``old new new old``), a fresh process runs that
checkout's ``chip_smoke.py`` phases that decode, route MoE layers and
train, with their own checks:

* ``moe_path``: mixtral-8x7b serving (8 of 32 layers) and grok-1-314b's
  greedy prefill and decode steps (2 of 64 layers);
* ``int8_kv_path``: deepseek-7b's greedy decode from int8 caches;
* ``serve_swa_path("recurrentgemma-9b")``: serving with rolling caches;
* ``train_path`` and ``train_ssm_path``: qwen2-0.5b's and mamba2-130m's
  training steps at full width.

It prints each run's walls and writes them all to
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


def _child(tree: str) -> None:
    """Run the phases of ``tree``'s chip_smoke.py and print their walls
    on one line."""
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.setup()
    out: dict = {"tree": tree}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        out[f"{name}_s"] = time.perf_counter() - t0
        return res

    _, moe = timed("moe_path", cs.moe_path, dev)
    mix, grok = moe["mixtral-8x7b"], moe["grok-1-314b"]
    out["mixtral"] = {k: mix[k] for k in ("wall_s", "model_s", "oracle_s")}
    out["mixtral"]["profiled_ms"] = {k: v["wall_ms"] for k, v in
                                     mix["profiled"].items()}
    out["grok"] = {k: grok[k] for k in ("prefill_s", "decode_step_s")}
    _, int8 = timed("int8_kv_path", cs.int8_kv_path, dev)
    out["deepseek_int8"] = {k: int8["deepseek-7b-int8"][k]
                            for k in ("prefill_s", "decode_step_s")}
    _, rg = timed("serve_recurrentgemma", cs.serve_swa_path, dev,
                  "recurrentgemma-9b")
    out["recurrentgemma"] = {k: rg[k] for k in ("wall_s", "model_s",
                                                 "oracle_s")}
    _, tr = timed("train_path", cs.train_path, dev)
    out["qwen2_train"] = {k: tr[k] for k in ("step_wall_ms",
                                              "step_walls_ms")}
    _, ssm = timed("train_ssm_path", cs.train_ssm_path, dev)
    out["mamba2_train"] = {k: ssm[k] for k in ("step_wall_ms",
                                                "step_walls_ms")}
    print(TAG + json.dumps(out), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        _child(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
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
                [sys.executable, __file__, "--child", tree], stdout=f,
                stderr=subprocess.STDOUT, timeout=1800)
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
        {"card": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Readings that set a training cell's limits (run on the card):

    python3 portbench/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed of ``--seeds``: the program's set-up steps exactly as a
run of ``run.py`` takes them (no timed window) against the reference's,
and the compared numbers (the lower readings).  For each seed of
``--control-seeds``: the reference computed in the configuration's
control precision (``precision.control``; or each precision of
``reference/common.py`` that ``--controls`` names) in the program's
place, against the float32 reference.  For each seed of
``--fault-seeds``: the program with each planted fault of
``drivers/train.py`` (a state left unchanged, half the batch left out,
the step's answer altered where it is produced) against the reference.
One JSON line a reading, with both sides' records, goes to ``--out``
(and to standard output) as soon as it is made.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*",
                    help="precisions of reference/common.py to read; the "
                         "configuration's control by default")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*",
                    help="planted faults to read; every one by default")
    ap.add_argument("--model-dtype",
                    help="run the program in this compute dtype instead "
                         "of the configuration's (a witness, not a cell)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

    import torch

    from portbench import correctness, harness
    from portbench.reference import train as ref_train

    cell = harness.load_cell(args.workload, ROOT)
    controls = args.controls or [cell.config["precision"]["control"]]
    if args.model_dtype:
        cell.config["model"]["dtype"] = args.model_dtype
    drv = harness.driver(cell)
    faults = args.faults or sorted(drv.FAULTS)
    steps = cell.traffic["setup_steps"]
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        rec = {"workload": cell.name, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, fault=None):
        prog = drv.Program(cell.config, cell.traffic, seed, args.device,
                           fault=fault)
        found = prog.setup_steps(steps)
        prog.state = None
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return found

    if torch.device(args.device).type == "cuda":
        emit(kind="device", name=torch.cuda.get_device_name(0))
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        found = program(seed)
        t1 = time.perf_counter()
        ref = ref_train.follow(cell.config, cell.traffic, seed, args.device,
                               steps)
        t2 = time.perf_counter()
        emit(kind="program", seed=seed, dtype=cell.config["model"]["dtype"],
             numbers=correctness.numbers(found, ref), record=found,
             reference=ref, program_s=t1 - t0, reference_s=t2 - t1)
        if seed in args.control_seeds:
            for precision in controls:
                low = ref_train.follow(cell.config, cell.traffic, seed,
                                       args.device, steps, precision)
                emit(kind=f"control:{precision}", seed=seed,
                     numbers=correctness.numbers(low, ref), record=low)
        if seed in args.fault_seeds:
            for fault in faults:
                found = program(seed, fault)
                emit(kind=f"fault:{fault}", seed=seed,
                     numbers=correctness.numbers(found, ref), record=found)
    return 0


if __name__ == "__main__":
    sys.exit(main())

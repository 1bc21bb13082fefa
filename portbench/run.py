"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read from the benchmark's spans, the port's launch counters
and a ``torch.profiler`` trace of a few steps after the timed window.
Either way the run checks what the timed path produced against the
plain reference (``portbench/correctness.py``) and prints each compared
number beside its limit as the last lines on standard error and under
``checks``, the last key of the result.  The last line of standard
output is the result, one JSON object.

Exits non-zero without a result when CUDA is missing or has fewer
cards than the cell asks for, when the port is not beside the
benchmark (``src/repro_torch``), or when the process has loaded JAX or
the JAX package.  Kernel builds stay inside the checkout
(``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the
    checkout."""
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    # the checkout and the port importable; this folder itself not (its
    # module names are the benchmark's, not top-level ones)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]
    from portbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 3

    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    result, lines = harness.run_cell(
        cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
        device="cuda:0", t_start=T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"the process loaded {loaded}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 4
    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Launch every kernel on a card that is not the current one.

Each of ``chip_smoke.py``'s kernel checks (convcore and postproc, ssd,
swa, the swa and ssd backward passes, the two LLC kernels, the NoC
switch) runs in a process of its own with card 0 current and every
operand on card ``--card``: each wrapper's launch held against its plain
version on the same inputs, as on the main path.  A process of its own,
so that a launch that corrupts its context cannot touch the next check.
Launches block (``CUDA_LAUNCH_BLOCKING=1``), so that an error surfaces
at the call that caused it.  Prints one JSON line: check -> "ok" or its
error (the exception's line and the innermost frame of the port or of
``chip_smoke.py``); ``--log-dir`` keeps each check's whole output.

    python3 scripts/launch_devices.py [--card 1] [--tree DIR] [--log-dir DIR]

``--tree`` runs another checkout's package (the parent commit unpacked
by ``git archive`` into an ignored directory, say) under this
checkout's ``chip_smoke.py`` checks; its kernels load from this
checkout's ``build/kernels``, whose libraries are named by a hash of
their sources, so that the same sources are not built twice.  Needs two
CUDA cards.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKS = ("check_kernels", "check_ssd", "check_swa", "check_swa_bwd",
          "check_ssd_bwd", "check_llc", "check_noc")

CHILD = """
import importlib.util, pathlib, sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import _build
_build.BUILD_DIR = pathlib.Path({build!r})
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
torch.cuda.set_device(0)
getattr(cs, {check!r})(torch.device("cuda", {card}))
torch.cuda.synchronize({card})
"""


def summary(stderr: str) -> str:
    """A failed check's exception line and its innermost frame in the
    port or in ``chip_smoke.py``."""
    lines = stderr.strip().splitlines()
    error = next((ln for ln in reversed(lines)
                  if re.match(r"^[\w.]*(Error|Exception)\b", ln)),
                 lines[-1] if lines else "no output")
    frames = [ln.strip() for ln in lines if ln.strip().startswith("File ")
              and ("repro_torch" in ln or "chip_smoke" in ln)]
    return error + (f" (at {frames[-1]})" if frames else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card", type=int, default=1)
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--log-dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    _build.build()
    out = {}
    for check in CHECKS:
        code = CHILD.format(src=str(Path(args.tree).resolve() / "src"),
                            build=str(ROOT / "build" / "kernels"),
                            smoke=str(ROOT / "chip_smoke.py"), check=check,
                            card=args.card)
        try:
            done = subprocess.run([sys.executable, "-c", code],
                                  capture_output=True, text=True,
                                  timeout=args.timeout,
                                  env={**os.environ,
                                       "CUDA_LAUNCH_BLOCKING": "1"})
        except subprocess.TimeoutExpired:
            out[check] = f"timed out after {args.timeout} s"
            continue
        if args.log_dir:
            log = Path(args.log_dir) / f"{Path(args.tree).name}-{check}.log"
            log.parent.mkdir(parents=True, exist_ok=True)
            log.write_text(done.stdout + done.stderr)
        out[check] = "ok" if done.returncode == 0 else summary(done.stderr)
    print(json.dumps({"tree": args.tree, "card": args.card,
                      "current": 0, "checks": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

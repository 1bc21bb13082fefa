"""Where a training step's memory on the card and the dry-run's trace of
it part: the caching allocator's history of one step (its blocks live at
the step's peak, with the Python frame that allocated each) against
``launch.dryrun.step_memory``'s live storages at its traced peak (with
the op that made each).

Run on the card (``--device cpu`` runs the trace side only):
    PYTHONPATH=src python3 scripts/step_memory_probe.py --arch qwen2-0.5b [--full]

``--full`` takes the arch's full config at chip_smoke.py's training
shape (qwen2-0.5b 4 x 1024, mamba2-130m 4 x 2048); otherwise the smoke
config at 4 x 512.  One warm-up step first (kernels, cuBLAS workspace);
then the bracketed step three ways: as measured, after ``gc.collect()``,
and after ``gc.collect()`` with the allocator's history on.  Writes the
blocks live at each peak to ``chiprun_out/step_memory_probe.json``.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticStream  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train.optim import AdamWConfig  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.types import param_values  # noqa: E402

FULL_SHAPES = {"qwen2-0.5b": (4, 1024), "mamba2-130m": (4, 2048)}


def _where(frames) -> str:
    """The innermost frame in this repository, else the innermost."""
    for f in frames:
        if "repro_torch" in f["filename"] or "scripts" in f["filename"]:
            return f"{f['filename'].split('src/')[-1]}:{f['line']} {f['name']}"
    return f"{frames[0]['filename']}:{frames[0]['line']}" if frames else "?"


def card_peak(snapshot: dict) -> tuple[int, list, int]:
    """(peak of bytes allocated less freed since the history began, the
    blocks allocated in it and live at that peak as (bytes, where),
    bytes of blocks from before it freed before the peak)."""
    live, peak, blocks, at_peak, freed_old = 0, 0, {}, [], 0
    old_freed_before_peak = 0
    for e in snapshot["device_traces"][0]:
        if e["action"] == "alloc":
            live += e["size"]
            blocks[e["addr"]] = (e["size"], _where(e.get("frames", [])))
            if live > peak:
                peak, at_peak = live, list(blocks.values())
                old_freed_before_peak = freed_old
        elif e["action"] == "free_completed":
            live -= e["size"]
            if blocks.pop(e["addr"], None) is None:
                freed_old += e["size"]
    return peak, at_peak, old_freed_before_peak


def traced_peak(step_fn, state, batch) -> tuple[int, list]:
    """(the trace's peak inside the step, its storages live there as
    (bytes, op))."""
    from torch.utils._python_dispatch import TorchDispatchMode

    current = ["?"]

    class OpName(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            current[0] = str(func)
            return func(*args, **(kwargs or {}))

    made: dict = {}
    at_peak: list = []
    make = dryrun._live_bytes_mode

    def watched(inputs, device):
        mode = make(inputs, device)
        count = mode._count

        def _count(st):
            before, new = mode.peak, id(st) not in mode._held
            count(st)
            if new and id(st) in mode._held:
                made[id(st)] = current[0]
            if mode.peak > before:
                at_peak[:] = [(held[1], made.get(key, "?"))
                              for key, held in mode._held.items()]
        mode._count = _count
        return mode

    dryrun._live_bytes_mode = watched
    try:
        with OpName():
            _, memory = dryrun.step_memory(step_fn, state, batch)
    finally:
        dryrun._live_bytes_mode = make
    return memory["peak_bytes"] - memory["argument_bytes"], at_peak


def grouped(blocks: list, top: int = 25) -> list:
    by = collections.Counter()
    n = collections.Counter()
    for size, where in blocks:
        by[where] += size
        n[where] += 1
    return [(where, by[where], n[where]) for where, _ in by.most_common(top)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=sorted(FULL_SHAPES))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    b, s = FULL_SHAPES[args.arch] if args.full else (4, 512)
    dev = torch.device(args.device)
    step_fn = make_train_step(cfg, AdamWConfig())
    stream = SyntheticStream(cfg, b, s, seed=0, device=dev)
    batch = stream.batch_at(1)
    meta_state = init_train_state(param_values(init_params(0, cfg,
                                                           device="meta")))
    traced, traced_blocks = traced_peak(step_fn, meta_state, {
        k: torch.empty_like(v, device="meta") for k, v in batch.items()})
    out = {"arch": args.arch, "full": args.full, "shape": [b, s],
           "traced": traced, "traced_at_peak": grouped(traced_blocks)}
    print(f"{args.arch} {'full' if args.full else 'smoke'} {b} x {s}: "
          f"traced {traced:,}")
    if dev.type == "cuda":
        state = init_train_state(param_values(init_params(0, cfg,
                                                          device=dev)))
        state, _ = step_fn(state, stream.batch_at(0))
        for name in ("as measured", "after gc", "history"):
            if name != "as measured":
                gc.collect()
            if name == "history":
                torch.cuda.memory._record_memory_history(
                    max_entries=2_000_000, stacks="python")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            step_fn(state, batch)
            card = torch.cuda.max_memory_allocated() - base
            out[name] = card
            print(f"  card {name}: {card:,} ({traced - card:+,} traced - "
                  "card)")
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        peak, blocks, old = card_peak(snap)
        out.update(history_peak=peak, old_freed_before_peak=old,
                   card_at_peak=grouped(blocks))
        print(f"  history: peak {peak:,}, blocks from before freed before "
              f"it {old:,}")
        for where, size, n in out["card_at_peak"]:
            print(f"    card  {size:>14,} in {n:5d} blocks  {where}")
    for where, size, n in out["traced_at_peak"]:
        print(f"    trace {size:>14,} in {n:5d} storages {where}")
    path = ROOT / "chiprun_out" / "step_memory_probe.json"
    path.parent.mkdir(exist_ok=True)
    runs = json.loads(path.read_text()) if path.exists() else []
    path.write_text(json.dumps(runs + [out], indent=1))


if __name__ == "__main__":
    main()

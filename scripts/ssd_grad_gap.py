"""Where the gap between the SSD kernels' training gradients and the
plain SSD's comes from, in bf16 and in fp32 compute, on the card.

One mamba2-130m training step (full width and depth, 4 x 2048 tokens
from the synthetic stream, layer remat) is taken five ways that differ
only in how each layer's intra-chunk SSD (``kernels.ssd.ops``) is
computed:

    KK  the forward kernel and the backward kernel (the training path)
    KP  the forward kernel, the plain backward
    PK  the plain forward, the backward kernel
    PP  the plain forward and backward in fp32
    DD  the plain forward and backward in float64, rounded to fp32

For each of ``SEEDS`` (parameters and stream), at initialisation and after
``TRAIN_STEPS`` AdamW steps (lr 3e-3, warmup 5, decay 100, as
``chip_smoke.train_ssm_path``), and in each compute dtype, it prints
each way's loss and grad norm and, against PP and against DD, the worst
leaf's ||g - g_ref|| / ||g_ref||, A_log's, and the worst other leaf's.
PP against DD is the control: the same plain code, moved by nothing but
the SSD's fp32 rounding.  Every reading goes to
``chiprun_out/ssd_grad_gap.json``.

    python3 scripts/ssd_grad_gap.py
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticStream  # noqa: E402
from repro_torch.kernels.ssd import kernel as K  # noqa: E402
from repro_torch.kernels.ssd import ops, ref  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train.optim import AdamWConfig  # noqa: E402
from repro_torch.train.step import (grads_of, init_train_state,  # noqa: E402
                                    make_train_step)
from repro_torch.types import (Param, global_norm, param_values,  # noqa: E402
                               tree_leaves)

ARCH, BATCH, SEQ, TRAIN_STEPS = "mamba2-130m", 4, 2048, 8
SEEDS = (0, 1, 2)
WAYS = ("KK", "KP", "PK", "PP", "DD")


def _kernel_fwd(*operands):
    return K.ssd_intra_chunk_kernel(*(ops._aligned(t) for t in operands))


def _kernel_bwd(*operands):
    return K.ssd_intra_chunk_bwd_kernel(*(ops._aligned(t) for t in operands))


def _in_float64(fn):
    def run(*operands):
        return tuple(t.to(torch.float32)
                     for t in fn(*(t.to(torch.float64) for t in operands)))
    return run


FWD = {"K": _kernel_fwd, "P": ref.ssd_intra_chunk_ref,
       "D": _in_float64(ref.ssd_intra_chunk_ref)}
BWD = {"K": _kernel_bwd, "P": ref.ssd_intra_chunk_bwd_ref,
       "D": _in_float64(ref.ssd_intra_chunk_bwd_ref)}


def ssd_op(way: str):
    """``ops.ssd_intra_chunk`` with the forward and backward of ``way``."""
    fwd, bwd = FWD[way[0]], BWD[way[1]]

    class Step(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *operands):
            ctx.save_for_backward(*operands)
            return fwd(*operands)

        @staticmethod
        def backward(ctx, gy, gst):
            return bwd(*ctx.saved_tensors, gy, gst)

    def step(x, dt, A, B, C, chunk):
        operands = ops._chunked(x, dt, A, B, C, chunk)
        if torch.is_grad_enabled():
            y, states = Step.apply(*operands)
        else:
            y, states = fwd(*operands)
        return y, states, operands[2]

    def op(x, dt, A, B, C, *, chunk):
        return ops._per_group(step, x, dt, A, B, C, chunk)
    return op


def leaf_names(tree, prefix="") -> list[str]:
    """Leaf paths in ``tree_leaves``' order (dict keys sorted)."""
    if isinstance(tree, Param):
        return leaf_names(tree.value, prefix)
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}/{i}")]
    return [prefix or "/"]


def take(params, batch, cfg, way: str) -> dict:
    saved = ops.ssd_intra_chunk
    ops.ssd_intra_chunk = ssd_op(way)
    before = (K.launches, K.bwd_launches)
    try:
        g, m = grads_of(params, batch, cfg)
    finally:
        ops.ssd_intra_chunk = saved
    return {"grads": [t.float() for t in tree_leaves(g)],
            "loss": float(m["loss"]), "grad_norm": float(global_norm(g)),
            "launches": (K.launches - before[0], K.bwd_launches - before[1])}


def gaps(a: dict, b: dict, names: list[str]) -> dict:
    rels = [float((x - y).norm() / y.norm().clamp_min(1e-30))
            for x, y in zip(a["grads"], b["grads"])]
    worst = max(range(len(rels)), key=rels.__getitem__)
    a_log = [i for i, n in enumerate(names) if n.endswith("A_log")]
    others = [i for i in range(len(rels)) if i not in a_log]
    other = max(others, key=rels.__getitem__)
    return {"loss": a["loss"] - b["loss"],
            "grad_norm_rel": (a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
            "worst": (names[worst], rels[worst]),
            "a_log": max(rels[i] for i in a_log),
            "worst_other": (names[other], rels[other]), "leaves": rels}


def run(seeds, dev) -> dict:
    """The readings at every seed, step count and dtype (printed)."""
    cfg = get_config(ARCH)
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    records = []
    t0 = time.perf_counter()
    for seed in seeds:
        state = init_train_state(param_values(init_params(seed, cfg,
                                                          device=dev)))
        stream = SyntheticStream(cfg, BATCH, SEQ, seed=seed, device=dev)
        names = leaf_names(state.params)
        step_fn = make_train_step(cfg, opt)
        done = 0
        for steps in (0, TRAIN_STEPS):
            while done < steps:
                state, _ = step_fn(state, stream.batch_at(done))
                done += 1
            batch = stream.batch_at(0)
            for dtype in ("bfloat16", "float32"):
                c = dataclasses.replace(cfg, dtype=dtype)
                runs = {w: take(state.params, batch, c, w) for w in WAYS}
                rec = {"seed": seed, "steps": steps, "dtype": dtype,
                       "ways": {w: {k: r[k] for k in
                                    ("loss", "grad_norm", "launches")}
                                for w, r in runs.items()},
                       "vs_PP": {w: gaps(runs[w], runs["PP"], names)
                                 for w in WAYS if w != "PP"},
                       "vs_DD": {w: gaps(runs[w], runs["DD"], names)
                                 for w in WAYS if w != "DD"}}
                records.append(rec)
                del runs
                print(f"seed {seed}, after {steps} steps, {dtype}: losses "
                      + ", ".join(f"{w} {v['loss']:.6f}"
                                  for w, v in rec["ways"].items())
                      + "; grad norms "
                      + ", ".join(f"{w} {v['grad_norm']:.5f}"
                                  for w, v in rec["ways"].items()),
                      flush=True)
                for ref_way in ("PP", "DD"):
                    for w, gp in rec[f"vs_{ref_way}"].items():
                        print(f"  {w} vs {ref_way}: loss {gp['loss']:+.3e}, "
                              f"grad norm {gp['grad_norm_rel']:+.3e}, A_log "
                              f"{gp['a_log']:.3e}, worst other leaf "
                              f"{gp['worst_other'][1]:.3e} "
                              f"({gp['worst_other'][0]})", flush=True)
        del state
    print(f"{len(records)} readings in {time.perf_counter() - t0:.1f} s")
    return {"names": names, "records": records}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device (the SSD kernels)", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    result = run(SEEDS, torch.device("cuda"))
    out = ROOT / "chiprun_out" / "ssd_grad_gap.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(f"written to {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

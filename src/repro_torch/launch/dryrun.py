"""Multi-pod dry-run of the port: trace every (arch x shape x mesh) cell.

Per cell, the step the port runs — ``train.step.make_train_step(...,
microbatches=)``, ``models.prefill`` or ``models.slot_decode_step`` —
runs once at full width and full depth on meta tensors (shapes, no
storage) distributed as DTensors over a placeholder process group of
256 (``pod``) or 512 (``multipod``) ranks
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing).  This process plays rank 0; every
rank's shards have the same shapes, so its local view is each device's.

What a cell records (the reference's keys, per device):

* ``memory``: ``argument_bytes`` and ``output_bytes``, exact from the
  local shard shapes of the step's inputs and outputs.  There is no
  compiler, so there are no temp bytes.
* ``cost``: ``flops`` — every local matmul's FLOPs by
  ``torch.utils.flop_counter``'s formulas plus the kernels' (swa, ssd
  and their backward passes: their meta routes record what the kernels
  would do on the local shards, ``kernels.meta``); replicated work is
  counted on every device, as it runs there; elementwise ops are not
  counted.  ``bytes`` — the sum of every local op's input and output
  bytes, views excepted: an unfused upper bound.  ``wire_bytes`` and
  ``coll_counts`` — the functional collectives DTensor issued, sized by
  ``hlo_analysis.collectives_from_trace``'s ring formulas; their number
  is checked against ``CommDebugMode``'s.
* ``roofline`` with the H100's constants (``launch.mesh``),
  ``model_flops`` (6ND train, 2ND prefill, 2N a token decode) and
  ``model_flops_ratio``.

The local ops are seen through a dispatch mode that hands DTensor ops
back to DTensor (a mode above DTensor would see global shapes) and then
sees the local ops DTensor runs, with their local shapes.  The
collective counts are the port's own — DTensor's redistributions, not
XLA's SPMD partitioner's — so they are not held to the reference's.
DTensor issues a shard-dim all-to-all on a CPU mesh as an all-gather
and a chunk (gloo has no all-to-all); the placeholder group moves
nothing either way, so the trace issues the all-to-all a GPU mesh runs
(``_all_to_all_as_on_gpus``).

Importing this module sets no environment variable and starts no
process group: ``run_cell`` makes its placeholder group and destroys it
on the way out.  An op that DTensor cannot shard makes the cell an
``error`` naming the op.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.hlo_analysis import (
    FUNCOL_OPS,
    collectives_from_trace,
    roofline_terms,
)
from repro_torch.launch.specs import (
    abstract_decode_state,
    abstract_params,
    abstract_train_state,
    batch_shardings,
    batch_specs,
    param_sharding_tree,
    token_count,
)
from repro_torch.types import param_values, tree_leaves, tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../build/dryrun")


# --------------------------------------------------------------------------
# the placeholder world and the inputs on it
# --------------------------------------------------------------------------
@contextlib.contextmanager
def placeholder_world(n: int):
    """A fake process group of ``n`` ranks (this process rank 0) for the
    block, destroyed after; an existing group of ``n`` ranks is used as
    it is."""
    import torch.distributed as dist
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the mesh needs {n}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _all_to_all_as_on_gpus():
    """DTensor's shard-dim all-to-all as its op, on the CPU mesh too."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev


def distribute(values, shardings, device_mesh):
    """A tree of meta tensors as DTensors with the placements of the
    matching ``shardings`` tree (``None`` leaves pass through)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(
        lambda v, p: v if v is None else distribute_tensor(
            v, device_mesh, list(p)), values, shardings)


def local_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` on one device: a DTensor's
    local shard, a plain tensor whole."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


# --------------------------------------------------------------------------
# the step of a cell
# --------------------------------------------------------------------------
def build_step(cfg, shape, device_mesh, *, microbatches: int = 1):
    """(step function, its distributed arguments) under the active
    rules."""
    from repro_torch.models import prefill, slot_decode_step

    if shape.mode == "train":
        from repro_torch.train.optim import AdamWConfig
        from repro_torch.train.step import make_train_step

        state, state_sh = abstract_train_state(cfg)
        batch = batch_specs(cfg, shape, with_labels=True)
        b_sh = batch_shardings(batch)
        state = dataclasses.replace(
            state, params=distribute(state.params, state_sh.params,
                                     device_mesh),
            opt=distribute(state.opt, state_sh.opt, device_mesh),
            step=distribute(state.step, state_sh.step, device_mesh))
        step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
        return step, (state, distribute(batch, b_sh, device_mesh))
    if shape.mode == "prefill":
        params_p = abstract_params(cfg)
        params = distribute(param_values(params_p),
                            param_sharding_tree(params_p), device_mesh)
        batch = batch_specs(cfg, shape, with_labels=False)
        batch = distribute(batch, batch_shardings(batch), device_mesh)
        return (lambda p, b: prefill(p, b, cfg, shape.seq_len)), \
            (params, batch)
    args, shardings = abstract_decode_state(cfg, shape)
    args = tuple(distribute(a, s, device_mesh)
                 for a, s in zip(args, shardings))
    return (lambda p, c, tok, ts: slot_decode_step(p, c, tok, ts, cfg)), args


# --------------------------------------------------------------------------
# counting the local ops
# --------------------------------------------------------------------------
# creation ops that allocate without moving data
_NO_TRAFFIC = ("empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like")


def _tensor_bytes(x) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _cost_mode():
    """A dispatch mode that counts the local ops DTensor runs: FLOPs,
    bytes and the collectives (name, result bytes, group size)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class CostMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.collectives: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented      # let DTensor run; see its locals
            out = func(*args, **kwargs)
            inputs = [t for t in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)]
            if any(isinstance(t, FakeTensor) for t in inputs):
                return out                 # DTensor's shape propagation
            packet = func._overloadpacket
            if func.namespace.startswith("_c10d_functional") \
                    or func.namespace == "_dtensor":
                if packet.__name__ in FUNCOL_OPS:
                    group = next(a for a in reversed(args)
                                 if isinstance(a, str))
                    self.collectives.append((
                        packet.__name__, _tensor_bytes(out),
                        _resolve_process_group(group).size()))
                return out
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in inputs) + _tensor_bytes(out)
            return out

    return CostMode()


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS (6ND train, 2ND prefill, 2N/token decode)."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * token_count(cfg, shape)
    if shape.mode == "train":
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             overrides: dict | None = None,
             rule_overrides: dict | None = None,
             microbatches: int = 1) -> dict:
    """One cell's record.  ``rule_overrides``: logical-axis -> mesh-axes
    mapping overrides (e.g. {"act_seq": ("model",)} turns on sequence
    parallelism for activations)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import meta
    from repro_torch.sharding import activate_rules

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "rule_overrides": rule_overrides}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        out["skipped"] = reason
        return out

    n_dev = 512 if multi_pod else 256
    with placeholder_world(n_dev):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
        out["n_devices"] = mesh.size
        with activate_rules(mesh, rule_overrides) as rules, \
                implicit_replication(), _all_to_all_as_on_gpus():
            t0 = time.perf_counter()
            step, args = build_step(cfg, shape, mesh.device_mesh,
                                    microbatches=microbatches)
            out["memory"] = {"argument_bytes": local_bytes(args)}
            cost = _cost_mode()
            with meta.recording() as kernels, CommDebugMode() as comm, cost:
                result = step(*args)
            out["trace_s"] = round(time.perf_counter() - t0, 2)
            out["memory"]["output_bytes"] = local_bytes(result)
            out["dropped_axes"] = sorted(str(d) for d in rules.dropped)
    stats = collectives_from_trace(cost.collectives, n_devices=n_dev)
    if sum(stats.counts.values()) != comm.get_total_counts():
        raise RuntimeError(f"traced {sum(stats.counts.values())} "
                           f"collectives, CommDebugMode "
                           f"{comm.get_total_counts()}")
    by_kernel: dict = {}
    for name, flops, nbytes in kernels:
        k = by_kernel.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    largest = max(cost.collectives, key=lambda c: c[1], default=None)
    out["cost"] = {
        "flops": float(cost.flops + sum(k["flops"]
                                        for k in by_kernel.values())),
        "bytes": float(cost.bytes + sum(k["bytes"]
                                        for k in by_kernel.values())),
        "wire_bytes": stats.wire_bytes,
        "coll_counts": stats.counts,
        "coll_by_group_size": stats.by_group_size,
        "largest_collective": None if largest is None else {
            "op": largest[0], "result_bytes": largest[1],
            "group_size": largest[2]},
        "kernels": by_kernel,
    }
    cost_ = out["cost"]
    out["roofline"] = roofline_terms(
        flops=cost_["flops"], bytes_accessed=cost_["bytes"],
        wire_bytes=cost_["wire_bytes"], peak_flops=mesh_mod.PEAK_BF16_FLOPS,
        hbm_bw=mesh_mod.HBM_BW, link_bw=mesh_mod.NVLINK_BW)
    mf = model_flops(cfg, shape)
    out["model_flops"] = mf
    total = cost_["flops"] * n_dev
    out["model_flops_ratio"] = (mf / total) if total else None
    return out


def failing_op(tb: str) -> str | None:
    """The aten op a traceback's error names, if any."""
    last = tb.strip().splitlines()[-1] if tb.strip() else ""
    m = re.search(r"aten\.[\w.]+", last) or re.search(r"aten\.[\w.]+", tb)
    return m.group(0) if m else None


def _write(out: dict, artifact_dir: str) -> str:
    d = os.path.join(artifact_dir, out["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{out['arch']}__{out['shape']}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--perf", action="store_true",
                    help="apply the tuned PERF_PRESETS where available "
                         "(writes artifacts under <out>-perf)")
    args = ap.parse_args(argv)
    if args.perf and args.out == ARTIFACT_DIR:
        args.out = ARTIFACT_DIR + "-perf"
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    meshes = [False, True] if args.mesh == "both" \
        else [args.mesh == "multipod"]
    cells = ([(a, s) for a in ARCHS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failures = 0
    t_all = time.perf_counter()
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_name = "multipod" if mp else "pod"
            tag = f"{arch} x {shape_name} x {mesh_name}"
            path = os.path.join(args.out, mesh_name,
                                f"{arch}__{shape_name}.json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if "error" not in prev:
                    print(f"[keep] {tag}")
                    continue
            kw = {}
            if args.perf:
                from repro_torch.launch.presets import preset_for

                p = preset_for(arch, shape_name)
                if p:
                    kw = {"overrides": p.get("overrides") or None,
                          "rule_overrides": p.get("rule_overrides") or None,
                          "microbatches": p.get("microbatches", 1)}
            t0 = time.perf_counter()
            try:
                out = run_cell(arch, shape_name, mp, **kw)
            except Exception:    # the sweep goes on; the cell records why
                tb = traceback.format_exc()
                out = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "error": tb, "error_op": failing_op(tb),
                       "seconds": round(time.perf_counter() - t0, 2)}
                failures += 1
                print(f"[FAIL] {tag}: {tb.strip().splitlines()[-1][:300]}",
                      flush=True)
            else:
                if "skipped" in out:
                    print(f"[skip] {tag}: {out['skipped']}", flush=True)
                else:
                    r, c = out["roofline"], out["cost"]
                    print(f"[ ok ] {tag}: trace {out['trace_s']}s "
                          f"dominant={r['dominant']} "
                          f"compute={r['compute_s']:.4f}s "
                          f"mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"args={out['memory']['argument_bytes'] / 2**30:.2f}"
                          f"GiB collectives={sum(c['coll_counts'].values())}",
                          flush=True)
            _write(out, args.out)
    print(f"{len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t_all:.1f} s, {failures} failed")
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

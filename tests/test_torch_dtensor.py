"""The port's sharded path against its plain path, by value: four gloo
ranks on the CPU hold smoke-size parameters and batches as DTensors on a
(2, 2) ("data", "model") mesh, placed by the default sharding rules, and
run the loss and its gradients, a two-microbatch train step and a
split-K decode step.  The full tensors of every result must equal the
plain single-process run on the same inputs, in fp32.

This covers what only runs on DTensors: ``on_local_shards`` (its partial
gradients and its ``"sum"`` outputs: the attention output projection,
unembed, the vocab-parallel embedding), the vocab-parallel cross
entropy, ``logical_constraint`` on activations and their gradients, the
MoE routing on group shards, the microbatch split, and the select-write
and split-K combine of a sequence-sharded cache.  The smoke vocab (256)
and every smoke width divide by the mesh's axes, so the vocab, heads,
MLP and d_model dims are all sharded.

The same spawn checks the elastic restore: the parameters, saved from
(2, 2) DTensors (gathered whole), come back through
``checkpoint.restore(shardings=)`` on the (2, 2) and the (1, 4) mesh
with the placements asked for and the saved values.

``_compare`` and ``_worker`` take a backend and a device type:
``tests/test_torch_multicard.py`` runs the same cases over four NCCL
ranks, a card each, where the hand-written kernels run on the shards.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# fp32 partial sums over two shards against whole sums: the results differ
# by summation order only.  Each element may differ by RTOL of itself plus
# ATOL of the largest magnitude of its tensor.
RTOL, ATOL = 1e-5, 1e-5
# Where a case's shards run the SSD kernels on the card (3xTF32), the
# kernel's own tolerance: chip_smoke.py's SSD_TOL, the reference's for
# this kernel.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4

WORLD = 4
BATCH, SEQ = 4, 32


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _gap(got, want) -> list:
    """[max |got - want|, max of (|got - want| - its tolerance) at RTOL /
    ATOL, the same at KERNEL_RTOL / KERNEL_ATOL]."""
    got, want = _full(got).detach(), want.detach()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    got, want = got.to(torch.float64), want.to(torch.float64)
    err = (got - want).abs()
    top = float(want.abs().max())
    return [float(err.max())] + [
        float((err - atol * top - rtol * want.abs()).max())
        for rtol, atol in ((RTOL, ATOL), (KERNEL_RTOL, KERNEL_ATOL))]


def _device(device_type: str) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _kernel_launches() -> dict:
    """The swa / ssd wrappers' launch counts, forward and backward."""
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.swa import kernel as swa

    return {"swa": swa.launches, "swa_bwd": swa.bwd_launches,
            "ssd": ssd.launches, "ssd_bwd": ssd.bwd_launches}


def _batch(cfg, *, labels: bool, device="cpu"):
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    ).to(device)
    batch = {"tokens": toks[:, :-1].contiguous()}
    if labels:
        batch["labels"] = toks[:, 1:].contiguous()
    return batch


def _compare(arch: str, overrides: dict, device_type: str = "cpu"):
    """({what: [max abs gap, max(gap - tolerance)]} of the sharded run
    against the plain one, the kernel launches of the sharded run)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import batch_shardings, param_sharding_tree
    from repro_torch.models import init_caches, init_params, prefill
    from repro_torch.models import slot_decode_step
    from repro_torch.sharding import activate_rules, sharding_for
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import grads_of, init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.types import param_values, tree_flatten

    dev = _device(device_type)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params_p = init_params(0, cfg, device=dev)
    params = param_values(params_p)
    batch = _batch(cfg, labels=True, device=dev)
    mesh = make_mesh((2, 2), ("data", "model"), device_type=device_type)
    gaps: dict = {}

    want_g, want_m = grads_of(params, batch, cfg)
    want_state, want_sm = make_train_step(cfg, AdamWConfig(),
                                          microbatches=2)(
        init_train_state(params), batch)
    before = _kernel_launches()
    with activate_rules(mesh), implicit_replication():
        sh = param_sharding_tree(params_p)
        dparams = distribute(params, sh, mesh.device_mesh)
        dbatch = distribute(batch, batch_shardings(batch), mesh.device_mesh)
        g, m = grads_of(dparams, dbatch, cfg)
        state, sm = make_train_step(cfg, AdamWConfig(), microbatches=2)(
            init_train_state(dparams), dbatch)
    launches = {k: v - before[k] for k, v in _kernel_launches().items()}
    gaps["loss"] = _gap(m["loss"], want_m["loss"])
    for i, (a, w) in enumerate(zip(tree_flatten(g)[0],
                                   tree_flatten(want_g)[0])):
        gaps[f"grad[{i}]"] = _gap(a, w)
    gaps["microbatched loss"] = _gap(sm["loss"], want_sm["loss"])
    # AdamW's first moment after one step is (1 - beta1) x the gradient
    for i, (a, w) in enumerate(zip(tree_flatten(state.opt["m"])[0],
                                   tree_flatten(want_state.opt["m"])[0])):
        gaps[f"microbatched m[{i}]"] = _gap(a, w)

    if overrides:
        # a decode step from the plain prefill's caches, the cache
        # sequence-sharded where ``overrides`` shard it
        cfg = dataclasses.replace(cfg, **overrides.get("config", {}))
        cache_len = 64
        prompt = _batch(cfg, labels=False, device=dev)
        _, caches, t = prefill(params, prompt, cfg, cache_len)
        tokens = prompt["tokens"][:, -1:]
        ts = torch.arange(BATCH, dtype=torch.int32, device=dev) + t - BATCH
        want_logits, want_caches = slot_decode_step(params, caches, tokens,
                                                    ts, cfg)
        caches_p = init_caches(cfg, BATCH, cache_len, device="cpu")
        with activate_rules(mesh, overrides["rules"]):
            from repro_torch.models.attention import _splitk_shards

            gaps["split-K shards"] = [_splitk_shards(cfg, cache_len), 0.0,
                                      0.0]
            args = (distribute(params, sh, mesh.device_mesh),
                    distribute(caches, param_sharding_tree(caches_p),
                               mesh.device_mesh),
                    distribute(tokens, sharding_for(
                        tokens.shape, ("act_batch", None)), mesh.device_mesh),
                    distribute(ts, sharding_for(ts.shape, ("act_batch",)),
                               mesh.device_mesh))
            with implicit_replication():
                logits, new_caches = slot_decode_step(*args, cfg)
        gaps["decode logits"] = _gap(logits, want_logits)
        for i, (a, w) in enumerate(zip(tree_flatten(new_caches)[0],
                                       tree_flatten(want_caches)[0])):
            gaps[f"decode cache[{i}]"] = _gap(a, w)
    return gaps, launches


def _restore_onto_meshes(arch: str, ckpt_dir: str,
                         device_type: str = "cpu") -> dict:
    """Parameters saved from (2, 2) DTensors, restored through
    ``restore(shardings=)`` onto the (2, 2) and the (1, 4) mesh: per
    mesh, the leaves, those sharded, and whether every leaf has the
    placements asked for and the saved values."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import param_sharding_tree
    from repro_torch.models import init_params
    from repro_torch.sharding import activate_rules
    from repro_torch.types import param_values, tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    params_p = init_params(1, cfg, device=_device(device_type))
    params = param_values(params_p)
    out: dict = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), device_type=device_type)
        with activate_rules(mesh):
            sh = param_sharding_tree(params_p)
        if shape == (2, 2):
            dparams = distribute(params, sh, mesh.device_mesh)
            if dist.get_rank() == 0:
                save(dparams, ckpt_dir, 1)
            else:      # join the save's gathers, leaf by leaf
                for x in tree_leaves(dparams):
                    x.full_tensor()
            dist.barrier()
        got = restore(params, ckpt_dir, 1, shardings=sh,
                      device_mesh=mesh.device_mesh)
        placed = tree_leaves(tree_map(
            lambda g, p: g.device_mesh is mesh.device_mesh
            and tuple(g.placements) == tuple(p), got, sh))
        equal = [torch.equal(g.full_tensor(), w)
                 for g, w in zip(tree_leaves(got), tree_leaves(params))]
        out[str(shape)] = {
            "leaves": len(equal), "placed": all(placed),
            "equal": all(equal),
            "sharded": sum(any(p.is_shard() for p in g.placements)
                           for g in tree_leaves(got))}
    return out


def _worker(rank: int, store_path: str, cases: dict, out_path: str,
            backend: str = "gloo") -> None:
    """One rank of ``WORLD``: ``cases`` ({arch: overrides}) compared and
    restored in turn, the results written by rank 0 to ``out_path``.
    The gloo ranks run on the CPU, the NCCL ranks on card ``rank``."""
    import datetime
    import os

    import torch.distributed as dist

    torch.set_num_threads(1)
    device_type = "cuda" if backend == "nccl" else "cpu"
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        # a rank that dies leaves the others waiting: not for long
        kw.update(device_id=torch.device("cuda", rank),
                  timeout=datetime.timedelta(minutes=4))
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, **kw)
    try:
        results = {}
        for arch, overrides in cases.items():
            gaps, launches = _compare(arch, overrides, device_type)
            results[arch] = {
                "gaps": gaps, "launches": launches,
                "restore": _restore_onto_meshes(
                    arch, os.path.join(os.path.dirname(out_path),
                                       f"ckpt-{arch}"), device_type)}
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn(cases: dict, tmp, backend: str = "gloo") -> dict:
    """``_worker`` on ``WORLD`` spawned ranks over ``backend``: {arch:
    {"gaps", "launches", "restore"}}."""
    import torch.multiprocessing as mp

    out = tmp / "results.json"
    mp.start_processes(_worker, args=(str(tmp / "store"), cases, str(out),
                                      backend),
                       nprocs=WORLD, start_method="spawn")
    return json.loads(out.read_text())


CASES = {
    # dense, tied embeddings: the vocab-parallel lookup, unembed and
    # cross entropy on one table
    "qwen2-0.5b": {},
    # MoE, untied embeddings; decode with grok's preset (int8 KV,
    # cache_seq -> model: split-K over the model axis)
    "mixtral-8x7b": {"config": {"kv_cache_dtype": "int8"},
                     "rules": {"cache_seq": ("model",)}},
    # SSM blocks: the SSD on head shards
    "mamba2-130m": {},
    # recurrent blocks and local attention
    "recurrentgemma-9b": {},
    # decode from a cache in the compute dtype, sequence-sharded
    "grok-1-314b": {"rules": {"cache_seq": ("model",)}},
}


def over_tolerance(gaps: dict, kernel: bool = False) -> dict:
    """The gaps past RTOL / ATOL, or with ``kernel`` past KERNEL_RTOL /
    KERNEL_ATOL (the split-K shard count is no gap)."""
    return {k: v for k, v in gaps.items()
            if k != "split-K shards" and v[1 + kernel] > 0}


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """arch -> its four gloo ranks' results, spawned once an arch."""
    runs: dict = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = spawn({arch: CASES[arch]},
                               tmp_path_factory.mktemp(arch))[arch]
        return runs[arch]
    return get


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_step_equals_plain(arch, sharded_runs):
    gaps = sharded_runs(arch)["gaps"]
    over = over_tolerance(gaps)
    assert not over, f"{arch}: over rtol {RTOL}, atol {ATOL}: {over}"
    if "rules" in CASES[arch]:
        assert gaps["split-K shards"][0] == 2
        assert "decode logits" in gaps


@pytest.mark.parametrize("arch", sorted(CASES))
def test_restore_places_leaves_on_the_shardings(arch, sharded_runs):
    """Saved from (2, 2), restored onto (2, 2) and onto (1, 4): every
    leaf a DTensor of the placements asked for, with the saved values,
    and the (1, 4) mesh shards some leaf of every arch."""
    got = sharded_runs(arch)["restore"]
    for shape in ("(2, 2)", "(1, 4)"):
        assert got[shape]["placed"] and got[shape]["equal"], (shape, got)
        assert got[shape]["leaves"] == got["(2, 2)"]["leaves"] > 0
        assert got[shape]["sharded"] > 0, (shape, got)

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

WORLD = 4
BATCH, SEQ = 4, 32


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _gap(got, want) -> list:
    """[max |got - want|, max of (|got - want| - its tolerance)]."""
    got, want = _full(got).detach(), want.detach()
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    got, want = got.to(torch.float64), want.to(torch.float64)
    err = (got - want).abs()
    tol = ATOL * float(want.abs().max()) + RTOL * want.abs()
    return [float(err.max()), float((err - tol).max())]


def _batch(cfg, *, labels: bool):
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous()}
    if labels:
        batch["labels"] = toks[:, 1:].contiguous()
    return batch


def _compare(arch: str, overrides: dict) -> dict:
    """{what: [max abs gap, max(gap - tolerance)]} of the sharded run
    against the plain one."""
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

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params_p = init_params(0, cfg, device="cpu")
    params = param_values(params_p)
    batch = _batch(cfg, labels=True)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    gaps: dict = {}

    want_g, want_m = grads_of(params, batch, cfg)
    want_state, want_sm = make_train_step(cfg, AdamWConfig(),
                                          microbatches=2)(
        init_train_state(params), batch)
    with activate_rules(mesh), implicit_replication():
        sh = param_sharding_tree(params_p)
        dparams = distribute(params, sh, mesh.device_mesh)
        dbatch = distribute(batch, batch_shardings(batch), mesh.device_mesh)
        g, m = grads_of(dparams, dbatch, cfg)
        state, sm = make_train_step(cfg, AdamWConfig(), microbatches=2)(
            init_train_state(dparams), dbatch)
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
        prompt = _batch(cfg, labels=False)
        _, caches, t = prefill(params, prompt, cfg, cache_len)
        tokens = prompt["tokens"][:, -1:]
        ts = torch.arange(BATCH, dtype=torch.int32) + t - BATCH
        want_logits, want_caches = slot_decode_step(params, caches, tokens,
                                                    ts, cfg)
        caches_p = init_caches(cfg, BATCH, cache_len, device="cpu")
        with activate_rules(mesh, overrides["rules"]):
            from repro_torch.models.attention import _splitk_shards

            gaps["split-K shards"] = [_splitk_shards(cfg, cache_len), 0.0]
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
    return gaps


def _worker(rank: int, store_path: str, arch: str, overrides: dict,
            out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    try:
        gaps = _compare(arch, overrides)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(gaps, f)
    finally:
        dist.destroy_process_group()


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


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sharded_step_equals_plain(arch, tmp_path):
    import torch.multiprocessing as mp

    out = tmp_path / "gaps.json"
    mp.start_processes(_worker, args=(str(tmp_path / "store"), arch,
                                      CASES[arch], str(out)),
                       nprocs=WORLD, start_method="spawn")
    gaps = json.loads(out.read_text())
    over = {k: v for k, v in gaps.items()
            if k != "split-K shards" and v[1] > 0}
    assert not over, f"{arch}: over rtol {RTOL}, atol {ATOL}: {over}"
    if "rules" in CASES[arch]:
        assert gaps["split-K shards"][0] == 2
        assert "decode logits" in gaps

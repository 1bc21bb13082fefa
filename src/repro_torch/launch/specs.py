"""Abstract input and state specs of a cell (the reference's
``repro.launch.specs``), on the meta device.

Every tensor here is a meta tensor — shape and dtype, no storage — so
the dry-run (``repro_torch.launch.dryrun``) builds a full-width,
full-depth step without allocating a single parameter.  The sharding
trees are ``sharding_for`` results under the active rules: spec tuples,
or DTensor placements where the mesh carries a device mesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import init_caches, init_params
from repro_torch.sharding import sharding_for
from repro_torch.types import is_param, param_values, tree_map

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """Param tree with meta values."""
    return init_params(0, cfg, device=META)


def token_count(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Text-token length for a cell (VLM cells reserve patch positions)."""
    s = shape.seq_len
    if cfg.family == "vlm" and cfg.num_patches:
        s -= cfg.num_patches
    return s


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool):
    b = shape.global_batch
    s = token_count(cfg, shape)
    batch = {"tokens": _sds((b, s), torch.int32)}
    if with_labels:
        batch["labels"] = _sds((b, s), torch.int32)
    if cfg.is_encoder_decoder:
        batch["frames"] = _sds((b, cfg.encoder_len, cfg.d_model),
                               torch.float32)
    if cfg.family == "vlm" and cfg.num_patches:
        batch["patches"] = _sds((b, cfg.num_patches, cfg.d_model),
                                torch.float32)
    return batch


BATCH_AXES = {
    "tokens": ("act_batch", None),
    "labels": ("act_batch", None),
    "frames": ("act_batch", None, None),
    "patches": ("act_batch", None, None),
}


def batch_shardings(batch: dict):
    """Sharding tree for a batch dict under the active rules."""
    return {k: sharding_for(v.shape, BATCH_AXES[k]) for k, v in batch.items()}


def param_sharding_tree(abstract):
    """Param tree -> sharding tree (the same structure as its values)."""
    return tree_map(lambda p: sharding_for(p.value.shape, p.axes), abstract,
                    is_leaf=is_param)


def abstract_train_state(cfg: ModelConfig):
    """(TrainState of meta tensors, matching sharding tree)."""
    from repro_torch.train.step import TrainState

    params_p = abstract_params(cfg)
    values = param_values(params_p)
    shard = param_sharding_tree(params_p)
    fp32 = tree_map(lambda v: _sds(v.shape, torch.float32), values)
    rep = sharding_for((), ())
    state = TrainState(
        params=values,
        opt={"m": fp32, "v": fp32, "count": _sds((), torch.int32)},
        step=_sds((), torch.int32), ef=None)
    shardings = TrainState(
        params=shard, opt={"m": shard, "v": shard, "count": rep},
        step=rep, ef=None)
    return state, shardings


def abstract_decode_state(cfg: ModelConfig, shape: ShapeConfig):
    """((params, caches, tokens, ts) of meta tensors, matching shardings).

    The decode cell runs the serving engine's per-slot step
    (``models.slot_decode_step``): each batch row carries its own
    position ``ts[i]``."""
    b = shape.global_batch
    params_p = abstract_params(cfg)
    caches_p = init_caches(cfg, b, shape.seq_len, device=META)
    token = _sds((b, 1), torch.int32)
    ts = _sds((b,), torch.int32)
    args = (param_values(params_p), param_values(caches_p), token, ts)
    shardings = (
        param_sharding_tree(params_p),
        param_sharding_tree(caches_p),
        sharding_for((b, 1), ("act_batch", None)),
        sharding_for((b,), ("act_batch",)),
    )
    return args, shardings

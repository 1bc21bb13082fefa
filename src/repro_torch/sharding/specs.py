"""Logical-axis -> mesh-axis resolution with divisibility fallback (the
reference's ``repro.sharding.specs``).

Model code annotates parameters (``repro_torch.types.Param``) and
activations (:func:`logical_constraint`) with *logical* axis names.  A
launcher activates an :class:`AxisRules` (mesh + mapping) and every
annotation resolves to a spec: one entry per dimension, a mesh axis
name, a tuple of them or ``None``, trailing ``None``\\ s popped — the
entries of the reference's ``PartitionSpec``:

* each logical axis maps to an ordered tuple of candidate mesh axes;
* a candidate is used only if (a) it exists in the mesh, (b) it has not
  been consumed by an earlier dimension of the same array, and (c) the
  dimension size is divisible by the product of chosen axis sizes —
  otherwise it is dropped (this is how qwen2's 14 heads decline 16-way
  tensor parallelism while its MLP still shards);
* dropped axes are recorded so the dry-run can report them.

Resolution reads only the mesh's ``axis_names`` and ``shape``
(``repro_torch.launch.mesh.Mesh``), so it runs with no device and no
process group.  Where the mesh carries a
``torch.distributed.device_mesh.DeviceMesh`` (a process group of the
mesh's size exists), :func:`sharding_for` returns DTensor placements
and :func:`logical_constraint` redistributes a DTensor to them.

One difference from the reference: DTensor splits a tensor dimension
that several mesh axes shard in mesh-dimension order, where JAX splits
it in the order the spec lists them.  ``embed -> ("data", "pod")`` on
the (pod, data, model) mesh therefore gives every device a shard of the
same size as the reference's, but not the same rows.  The dry-run
counts sizes only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Sequence

import torch

from repro_torch.types import is_param, tree_map

# Parameter logical axes -------------------------------------------------
# "embed" is the FSDP axis: weight d_model dims shard over the data(+pod)
# axes, ZeRO-3 style; DTensor gathers each weight at its use.
DEFAULT_PARAM_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("data", "pod"),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "experts": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "ssm_heads": ("model",),
    "rglru": ("model",),
    "rglru_in": ("data", "pod"),
    "conv": (),
    "norm": (),
}

# Activation logical axes -------------------------------------------------
DEFAULT_ACT_RULES: dict[str, tuple[str, ...]] = {
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": (),
    "cache_seq": (),
    "act_ssm_inner": ("model",),
    "act_rglru": ("model",),
}


@dataclasses.dataclass
class AxisRules:
    """A mesh (``axis_names``, ``shape`` and, where a process group
    exists, ``device_mesh``) and the logical -> mesh axis mapping."""
    mesh: Any
    rules: dict[str, tuple[str, ...]]
    #: logical axes that failed divisibility at least once (reporting only)
    dropped: set = dataclasses.field(default_factory=set)

    def mesh_axis_size(self, name: str) -> int:
        return dict(zip(self.mesh.axis_names, self.mesh.shape))[name]


_state = threading.local()


def active_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def _using(rules: AxisRules | None, implicit: bool | None = None):
    """``rules`` active in this thread for the block, and DTensor's
    implicit replication of plain tensors set to ``implicit`` (left as
    it is where None); both restored after."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = getattr(_state, "rules", None), \
        dispatcher._allow_implicit_replication
    _state.rules = rules
    if implicit is not None:
        dispatcher._allow_implicit_replication = implicit
    try:
        yield rules
    finally:
        _state.rules = prev[0]
        if implicit is not None:
            dispatcher._allow_implicit_replication = prev[1]


@contextlib.contextmanager
def activate_rules(mesh, overrides: Mapping[str, tuple[str, ...]] | None
                   = None):
    """The default rules, ``overrides`` on top, active on ``mesh`` for
    the block (in this thread)."""
    rules = dict(DEFAULT_PARAM_RULES)
    rules.update(DEFAULT_ACT_RULES)
    if overrides:
        rules.update(overrides)
    with _using(AxisRules(mesh=mesh, rules=rules)) as active:
        yield active


def sharding_context():
    """A context manager that brings this thread's sharding state as it
    is now (the active rules, DTensor's implicit replication) into
    whichever thread enters it.  A checkpointed block's recompute needs
    it: on CUDA, autograd runs the backward in a thread of its own, where
    neither is set, and a recompute that placed its tensors otherwise
    would not match its forward pass."""
    from torch.distributed.tensor import DTensor

    return _using(active_rules(),
                  DTensor._op_dispatcher._allow_implicit_replication)


def spec_for(shape: Sequence[int], axes: Sequence[str | None],
             rules: AxisRules | None = None) -> tuple:
    """Resolve logical axes to a spec tuple under the active rules."""
    r = rules or active_rules()
    if r is None:
        raise RuntimeError("no active AxisRules; wrap in activate_rules(mesh)")
    used: set[str] = set()
    out: list = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in r.rules:
            out.append(None)
            continue
        chosen: list[str] = []
        factor = 1
        for mesh_ax in r.rules[ax]:
            if mesh_ax not in r.mesh.axis_names or mesh_ax in used:
                continue
            size = r.mesh_axis_size(mesh_ax)
            if dim % (factor * size) != 0:
                r.dropped.add((ax, mesh_ax, dim))
                continue
            chosen.append(mesh_ax)
            factor *= size
        used.update(chosen)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """A spec as DTensor placements on ``mesh``: ``Shard(dim)`` on each
    mesh axis that names tensor dimension ``dim``, ``Replicate()`` on
    the others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        for name in (entry,) if isinstance(entry, str) else entry or ():
            out[mesh.axis_names.index(name)] = Shard(dim)
    return tuple(out)


def sharding_for(shape, axes, rules: AxisRules | None = None):
    """The spec of ``shape``/``axes``, as DTensor placements where the
    mesh carries a device mesh."""
    r = rules or active_rules()
    spec = spec_for(shape, axes, r)
    if getattr(r.mesh, "device_mesh", None) is None:
        return spec
    return placements(spec, r.mesh)


def logical_constraint(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the placements its logical axes resolve
    to — and, in the backward pass, its gradient to the same placements,
    as JAX's sharding constraint binds the cotangent too; a plain tensor,
    or any tensor while no rules are active, passes through unchanged."""
    r = active_rules()
    if r is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or r.mesh.device_mesh is None:
        return x
    return x.redistribute(x.device_mesh,
                          placements(spec_for(x.shape, axes, r), r.mesh))


def param_shardings(param_tree, rules: AxisRules | None = None):
    """Param tree -> the matching tree of shardings (``sharding_for``)."""
    r = rules or active_rules()
    return tree_map(lambda p: sharding_for(p.value.shape, p.axes, r),
                    param_tree, is_leaf=is_param)


def abstract_param_shardings(values_tree, axes_tree,
                             rules: AxisRules | None = None):
    """Same as ``param_shardings`` from split (values, Param-with-axes)
    trees; ``values_tree`` may hold meta tensors (dry-run path)."""
    r = rules or active_rules()
    return tree_map(lambda v, a: sharding_for(v.shape, a.axes, r),
                    values_tree, axes_tree)


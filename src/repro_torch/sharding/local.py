"""Run a function on a DTensor's local shards.

A kernel wrapper (``kernels.swa``, ``kernels.ssd``) takes plain tensors,
and the MoE layer's routing gathers and scatters rows by index, which
DTensor cannot shard.  Each is a function that is independent along some
dimensions of its operands — the batch rows, the attention heads, the
MoE routing groups — so :func:`on_local_shards` keeps the operands
sharded along those dimensions only, redistributes every other sharded
dimension to replicated (a real collective, which a trace counts), calls
the function on the local shards and wraps its results back as DTensors
sharded as its operands were.  On plain tensors it is the plain call.

An operand that lacks a role kept sharded over a mesh dimension is
replicated there, and its gradient is then a partial sum over that mesh
dimension (``to_local``'s ``grad_placements``): the tensor-parallel
all-reduce of an activation's gradient.

A *role* names one such dimension.  ``dims`` gives, for each operand,
its tensor dimension of each role, or ``None`` where the operand lacks
that role; ``out_dims`` the same for each result, or ``"sum"`` where the
function contracts the role away (the result is then a partial sum over
the mesh dimensions that shard the role).  A role stays sharded over a
mesh dimension only where every operand that has the role is sharded
along it there.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and type(x) is not torch.Tensor \
        and hasattr(x, "placements")


def on_local_shards(fn: Callable, args: Sequence, dims: Sequence,
                    out_dims: Sequence, **kwargs):
    """``fn(*local args, **kwargs)`` on the local shards of ``args``,
    sharded along the roles of ``dims`` only; results (a tensor or a
    tuple of them) as DTensors sharded along ``out_dims``.  Non-tensor
    ``args`` pass through (their ``dims`` entry is ignored)."""
    lead = next((a for a in args if _is_dtensor(a)), None)
    if lead is None:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = lead.device_mesh
    n_roles = len(dims[0])
    keep = []                       # per mesh dim: the role kept, or None
    for j in range(mesh.ndim):
        role = None
        for r in range(n_roles):
            have = [(a, d[r]) for a, d in zip(args, dims)
                    if _is_dtensor(a) and d[r] is not None]
            if have and all(a.placements[j] == Shard(dim)
                            for a, dim in have):
                role = r
                break
        keep.append(role)

    def target(d, lacking=Replicate()):
        out = []
        for r in keep:
            dim = None if r is None else d[r]
            out.append(Replicate() if r is None else lacking if dim is None
                       else Partial() if dim == "sum" else Shard(dim))
        return tuple(out)

    local = []
    for a, d in zip(args, dims):
        if _is_dtensor(a):
            want = target(d)
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            a = a.to_local(grad_placements=target(d, Partial()))
        local.append(a)
    out = fn(*local, **kwargs)
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    wrapped = tuple(DTensor.from_local(o, mesh, target(d), run_check=False)
                    for o, d in zip(outs, out_dims))
    return wrapped[0] if single else wrapped

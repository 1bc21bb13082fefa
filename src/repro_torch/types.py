"""Parameter plumbing: values annotated with logical axis names.

Parameters carry *logical axis names* alongside their values, as in the
reference package, so a tree converted from it keeps its layout and a
later sharding slice has the names to map.  Trees are nested ``dict``s
and ``tuple``s with tensors (or ``Param``s) at the leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    """A parameter value annotated with logical axis names (one entry
    per dimension; ``None`` means "never shard this dimension")."""

    value: Any
    axes: tuple[str | None, ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """Apply ``fn`` leaf-wise over ``tree`` (and same-structured
    ``rest``): dicts and tuples/lists are nodes, anything else (or
    whatever ``is_leaf`` accepts) is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_values(tree):
    """Strip Param wrappers -> plain value tree."""
    return tree_map(lambda p: p.value, tree, is_leaf=is_param)


def _flatten(x, leaves: list, is_leaf):
    """``tree_flatten``'s walk: appends ``x``'s leaves to ``leaves`` and
    returns its structure.  A module-level function, not a closure that
    refers to itself: such a closure's cell holds it and its list in a
    reference cycle, and every leaf would live until Python's cyclic
    collector ran."""
    if is_leaf is not None and is_leaf(x):
        leaves.append(x)
        return "*"
    if x is None:
        return None
    if isinstance(x, Param):
        return ("param", x.axes, (_flatten(x.value, leaves, is_leaf),))
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", tuple(keys),
                tuple(_flatten(x[k], leaves, is_leaf) for k in keys))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, None,
                tuple(_flatten(v, leaves, is_leaf) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names,
                tuple(_flatten(getattr(x, n), leaves, is_leaf)
                      for n in names))
    leaves.append(x)
    return "*"


def tree_flatten(tree, *, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """Leaves of ``tree`` in JAX's order — dict keys sorted, tuples and
    lists in order, a dataclass's fields in declaration order (a
    ``Param``'s value, its axes kept in the structure), ``None`` a node
    with no leaves — and the structure to rebuild it from them
    (``tree_unflatten``).  Whatever numbers the leaves (checkpoint leaf
    indices, the optimizer's flat lists) uses this order, so a leaf's
    index is the reference's."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, is_leaf)


def _build(node, it):
    """``tree_unflatten``'s walk: the tree of ``node`` with leaves taken
    from the iterator ``it`` in order (module-level, as ``_flatten``)."""
    if node is None:
        return None
    if node == "*":
        return next(it)
    kind, aux, children = node
    values = [_build(c, it) for c in children]
    if kind == "param":
        return Param(values[0], aux)
    if kind == "dict":
        return dict(zip(aux, values))
    if kind == "tuple":
        return tuple(values)
    if kind == "list":
        return values
    return kind(**dict(zip(aux, values)))


def tree_unflatten(treedef, leaves) -> Any:
    """The tree of ``treedef`` (from ``tree_flatten``) with ``leaves``
    in its leaf order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if hasattr(x, "element_size"))


def tree_param_count(tree) -> int:
    return sum(int(math.prod(x.shape)) for x in tree_leaves(tree))


def cast_floating(tree, dtype):
    """Floating-point leaves cast to ``dtype``; others as they are."""
    def _cast(x):
        if hasattr(x, "is_floating_point") and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(_cast, tree)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d
    tensor): each leaf's sum of squares, then their sum, as the
    reference stacks and sums them."""
    leaves = [x.to(torch.float32).square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()

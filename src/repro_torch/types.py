"""Parameter plumbing: values annotated with logical axis names.

Parameters carry *logical axis names* alongside their values, as in the
reference package, so a tree converted from it keeps its layout and a
later sharding slice has the names to map.  Trees are nested ``dict``s
and ``tuple``s with tensors (or ``Param``s) at the leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


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

"""The numbers that decide ``correct`` for a training cell.

Both sides give a record of the first steps (``reference.train.follow``
and the training driver's set-up): each step's loss, each leaf's norm
of the first gradient as the optimizer got it, and each leaf's norm of
the parameters' change after the last set-up step.  Four numbers
compare them:

- ``first_loss_gap``: |loss - reference loss| / |reference loss| of the
  first step (the forward pass's precision alone);
- ``later_loss_gap``: the largest of the same over the later steps
  (which AdamW's first, nearly sign-like updates make noisier);
- ``grad_gap``: over the leaves, the largest gap between the program's
  norm and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``grad_median_gap``: the median over the leaves of those same gaps:
  the first step's precision, steady from seed to seed where the worst
  leaf and the later steps are not;
- ``update_gap``: the same for the change of the parameters, over the
  leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's (a leaf whose gradient is nought to rounding, as a key bias is
  under softmax, moves under Adam by round-off alone).

A cell's ``limits/<cell>.json`` lists the numbers it compares, each
with its limit and the readings it was set from; a number that has no
upper reading there (neither the control nor a planted fault reads
far above sound runs) is printed but not compared.
"""
from __future__ import annotations

import math
import statistics

MOVED = 1e-3


def _gaps(prog: dict, ref: dict, leaves) -> dict[str, float]:
    floor = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            if math.isfinite(prog[k]) else math.inf for k in leaves}


def _worst_leaf(prog: dict, ref: dict, leaves) -> tuple[float, str]:
    worst, name = 0.0, ""
    for k, gap in _gaps(prog, ref, leaves).items():
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, name = gap, k
    return worst, name


def numbers(prog: dict, ref: dict) -> dict[str, dict]:
    """{number: {"value": ..., "leaf": ...}} of a program record against
    the reference's."""
    if sorted(prog["grad_norm"]) != sorted(ref["grad_norm"]):
        raise ValueError("the program's leaves are not the reference's: "
                         f"{sorted(prog['grad_norm'])} against "
                         f"{sorted(ref['grad_norm'])}")
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog["loss"], ref["loss"], strict=True)]
    later = max(losses[1:])
    grad, grad_leaf = _worst_leaf(prog["grad_norm"], ref["grad_norm"],
                                  ref["grad_norm"])
    grad_median = statistics.median(
        _gaps(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"]).values())
    median_grad = statistics.median(ref["grad_norm"].values())
    moved = [k for k, g in ref["grad_norm"].items()
             if g >= MOVED * median_grad]
    update, update_leaf = _worst_leaf(prog["update_norm"],
                                      ref["update_norm"], moved)
    return {"first_loss_gap": {"value": losses[0]},
            "later_loss_gap": {"value": later,
                               "step": losses.index(later) + 1},
            "grad_gap": {"value": grad, "leaf": grad_leaf},
            "grad_median_gap": {"value": grad_median},
            "update_gap": {"value": update, "leaf": update_leaf,
                           "left_out": sorted(set(ref["grad_norm"])
                                              - set(moved))}}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every
    number lies within its limit."""
    checks = {k: {"value": found[k]["value"], "limit": limits[k]}
              for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks

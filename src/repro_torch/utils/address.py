"""Segment address arithmetic shared by the LLC engines' host code
(``core.cache``, ``core.socsim``) and their plain versions
(``kernels.llc.ref``): a segment is the accesses base + j*stride,
j in [0, count)."""
from __future__ import annotations

import torch


def fdiv(a, b):
    """Floor division (the reference's ``//`` on signed operands)."""
    return torch.div(a, b, rounding_mode="floor")


def first_access(blocks, base, stride, block_bytes):
    """Index (within the segment) of the first access landing in each of
    `blocks`."""
    lo = blocks * block_bytes - base
    return torch.where(lo <= 0, 0, fdiv(lo + stride - 1, stride))


def last_access(blocks, base, stride, count, block_bytes):
    """Index of the last segment access landing in each of `blocks`."""
    lo = blocks * block_bytes - base
    return torch.minimum(count - 1, fdiv(lo + block_bytes - 1, stride))

"""Cost records of kernels called on meta tensors.

A kernel wrapper given meta tensors (the dry-run's trace,
``repro_torch.launch.dryrun``) runs neither its kernel nor its plain
version: it makes outputs of the kernel's shapes and dtypes and calls
``record`` with the FLOPs and bytes the kernel would spend on those
operands, counted as ``chip_smoke.py``'s bounds count them.  Inside a
``recording()`` block the records are kept; outside they are dropped.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the (kernel, FLOPs, bytes) records of the block, in this
    thread, into the list it yields."""
    prev = getattr(_state, "log", None)
    log: list = []
    _state.log = log
    try:
        yield log
    finally:
        _state.log = prev


def record(kernel: str, flops: int, nbytes: int) -> None:
    log = getattr(_state, "log", None)
    if log is not None:
        log.append((kernel, int(flops), int(nbytes)))

"""A kernel's share of its roofline from the profiled steps.

``share`` takes the device time of the kernels whose names match, the
number of calls the program's launch counter saw over the same steps,
and one call's operations and bytes (counted by the metric's own file
from the cell's shapes: the work the algorithm needs, each input read
and each output written once, whatever kernel does it), and returns
100 x calls x least time a call / device time.  Where the trace holds
no such kernel or the counter saw no call it returns None, never 0.
"""
from __future__ import annotations

import re

from portbench import peaks


def share(run: dict, pattern: str, counter: tuple[str, str],
          flops: float, nbytes: float, peak_flops: float) -> float | None:
    tr = run["trace"]
    calls = run["launches"].get(counter, 0)
    if tr is None or not calls:
        return None
    seconds, _ = tr.kernel_seconds(re.compile(pattern))
    if seconds <= 0.0:
        return None
    return 100.0 * calls * peaks.least_seconds(flops, nbytes, peak_flops) \
        / seconds


def causal_pairs(s: int) -> int:
    """(query, key) pairs of full causal attention over ``s`` positions."""
    return s * (s + 1) // 2


def dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[name]


def ssd_call_shape(m: dict, b: int, s: int) -> tuple[int, int, int, int,
                                                     int]:
    """One SSD kernel call's (chunks, chunk length, heads, head_dim,
    state): a call covers one SSM group's heads over the whole batch."""
    q = m["ssm_chunk"]
    h = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    return b * (s // q), q, h // m["ssm_ngroups"], m["ssm_head_dim"], \
        m["ssm_state"]

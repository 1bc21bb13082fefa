"""``ssd_roofline`` (layer: kernels, ``csrc/ssd.cu``): the SSD's
intra-chunk forward kernels' share of their roofline, in %.

One call covers one SSM group's heads over the cell's batch, in chunks
of ``ssm_chunk`` positions.  A chunk needs, over its causal (l >= s)
pairs, C.B^T once (2 x state operations a pair) and for each head the
masked scores times x (2 x head_dim a pair) and the chunk's state
B^T.x (2 x chunk x state x head_dim); x, dt, the decay prefix, B and C
are read and y and the states written once, in float32.  The operation
peak is TF32's, so no route to the float32 result can read above 100%.
Calls are the port's launch counter."""
from portbench import peaks, roofline

LAYER = "kernels"
PATTERN = r"(?<![a-z])ssd_(?!bwd)"
COUNTERS = [("repro_torch.kernels.ssd.kernel", "launches")]


def work(m: dict, b: int, s: int) -> tuple[float, float]:
    cells, q, h, p, n = roofline.ssd_call_shape(m, b, s)
    pairs = roofline.causal_pairs(q)
    flops = cells * (2 * pairs * n + h * (2 * pairs * p + 2 * q * n * p))
    nbytes = 4 * cells * (2 * q * h * p + h * n * p + 2 * q * n + 2 * q * h)
    return flops, nbytes


def read(run: dict) -> float | None:
    t = run["traffic"]
    flops, nbytes = work(run["config"]["model"], t["global_batch"],
                         t["seq_len"])
    return roofline.share(run, PATTERN, tuple(COUNTERS[0]), flops, nbytes,
                          peaks.TF32_FLOPS)

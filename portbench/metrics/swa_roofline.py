"""``swa_roofline`` (layer: kernels, ``csrc/swa.cu``): the attention
forward kernels' share of their roofline, in %.

One call is causal attention over the whole row (the dense configs'
full context) for the cell's batch: per (query, key) pair and query
head, Q.K^T and P.V take 4 x head_dim operations; q, k and v are read
and the output written once, in the compute dtype.  The least time is
the larger of the operations at the bf16 peak and the bytes at HBM's
rate; calls are the port's launch counter over the profiled steps."""
from portbench import peaks, roofline

LAYER = "kernels"
PATTERN = r"(?<![a-z])swa_(?!bwd)"
COUNTERS = [("repro_torch.kernels.swa.kernel", "launches")]


def work(m: dict, b: int, s: int) -> tuple[float, float]:
    """(operations, bytes) of one forward call."""
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    flops = 4 * hd * roofline.causal_pairs(s) * hq * b
    nbytes = roofline.dtype_bytes(m["dtype"]) * b * s * hd * (2 * hq
                                                              + 2 * hkv)
    return flops, nbytes


def read(run: dict) -> float | None:
    t = run["traffic"]
    flops, nbytes = work(run["config"]["model"], t["global_batch"],
                         t["seq_len"])
    return roofline.share(run, PATTERN, tuple(COUNTERS[0]), flops, nbytes,
                          peaks.BF16_FLOPS)

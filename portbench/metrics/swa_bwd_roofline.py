"""``swa_bwd_roofline`` (layer: kernels, ``csrc/swa_bwd.cu``): the
attention backward kernels' share of their roofline, in %.

One call is the gradient of causal attention over the whole row for
the cell's batch: per (query, key) pair and query head the four
products dP = dO.V^T, dQ = dS.K, dK = dS^T.Q and dV = P^T.dO take
8 x head_dim operations (recomputing P is the implementation's choice
and is not counted); q, k, v, o and dO are read and dq, dk and dv
written once, in the compute dtype.  Calls are the port's backward
launch counter."""
from portbench import peaks, roofline

LAYER = "kernels"
PATTERN = r"(?<![a-z])swa_bwd"
COUNTERS = [("repro_torch.kernels.swa.kernel", "bwd_launches")]


def work(m: dict, b: int, s: int) -> tuple[float, float]:
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    flops = 8 * hd * roofline.causal_pairs(s) * hq * b
    nbytes = roofline.dtype_bytes(m["dtype"]) * b * s * hd * (4 * hq
                                                              + 4 * hkv)
    return flops, nbytes


def read(run: dict) -> float | None:
    t = run["traffic"]
    flops, nbytes = work(run["config"]["model"], t["global_batch"],
                         t["seq_len"])
    return roofline.share(run, PATTERN, tuple(COUNTERS[0]), flops, nbytes,
                          peaks.BF16_FLOPS)

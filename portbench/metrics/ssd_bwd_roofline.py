"""``ssd_bwd_roofline`` (layer: kernels, ``csrc/ssd_bwd.cu``): the SSD's
intra-chunk backward kernels' share of their roofline, in %.

One call is the gradient of one ``ssd_roofline`` call.  A chunk needs,
for each head, dS = dy.x^T and dx = S^T.dy over the causal pairs (2 x
head_dim a pair each) and the states' part of dx and dB (2 x chunk x
state x head_dim each), and once dC = dCB.B and dB = dCB^T.C over the
pairs (2 x state a pair each); recomputing C.B^T is the
implementation's choice and is not counted.  x, dt, the decay prefix,
B, C, dy and the states' gradient are read and dx, ddt, the prefix's
gradient, dB and dC written once, in float32.  TF32 peak.  Calls are
the port's backward launch counter."""
from portbench import peaks, roofline

LAYER = "kernels"
PATTERN = r"(?<![a-z])ssd_bwd"
COUNTERS = [("repro_torch.kernels.ssd.kernel", "bwd_launches")]


def work(m: dict, b: int, s: int) -> tuple[float, float]:
    cells, q, h, p, n = roofline.ssd_call_shape(m, b, s)
    pairs = roofline.causal_pairs(q)
    flops = cells * (h * (4 * pairs * p + 4 * q * n * p) + 4 * pairs * n)
    nbytes = 4 * cells * (3 * q * h * p + 4 * q * h + 4 * q * n + h * n * p)
    return flops, nbytes


def read(run: dict) -> float | None:
    t = run["traffic"]
    flops, nbytes = work(run["config"]["model"], t["global_batch"],
                         t["seq_len"])
    return roofline.share(run, PATTERN, tuple(COUNTERS[0]), flops, nbytes,
                          peaks.TF32_FLOPS)

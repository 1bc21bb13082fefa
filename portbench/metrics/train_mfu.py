"""``train_mfu`` (layer: device, the whole step): the model's operations
a step over the wall a step of the timed window times the card's bf16
peak, in %.

The model's operations a step, from the configuration's shapes: 6 x
the parameters that enter a product x the tokens (forward and
backward), plus 3 x the forward operations of the sequence mixer
(attention's causal pairs; the SSD's chunked products), the layers'
recomputation under remat not counted.  The embedding lookup, norms,
biases, the depthwise convolution and the elementwise work are not
products and do not count."""
from portbench import peaks, roofline

LAYER = "device"


def product_params(m: dict) -> int:
    """Parameters that enter a product, a token: every layer's
    projections and the (tied) unembedding."""
    d, n = m["d_model"], m["num_layers"]
    if m["family"] == "ssm":
        di = m["ssm_expand"] * d
        gn = m["ssm_ngroups"] * m["ssm_state"]
        h = di // m["ssm_head_dim"]
        layer = d * (2 * di + 2 * gn + h) + di * d
    else:
        hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        mlp = (3 if m.get("gated_mlp", True) else 2) * d * m["d_ff"]
        layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + mlp
    return n * layer + m["vocab_size"] * d


def mixer_forward_flops(m: dict, b: int, s: int) -> int:
    """One forward pass of every layer's sequence mixer beyond its
    projections."""
    if m["family"] == "ssm":
        cells, q, hc, p, n = roofline.ssd_call_shape(m, b, s)
        g = m["ssm_ngroups"]
        pairs = roofline.causal_pairs(q)
        h = hc * g
        per_cell = 2 * pairs * n * g + 2 * pairs * p * h \
            + 2 * (2 * q * n * p * h)          # the states in, and out
        return m["num_layers"] * cells * per_cell
    return m["num_layers"] * 4 * m["head_dim"] * m["num_heads"] * b \
        * roofline.causal_pairs(s)


def step_flops(m: dict, b: int, s: int) -> int:
    return 6 * product_params(m) * b * s + 3 * mixer_forward_flops(m, b, s)


def read(run: dict) -> float | None:
    if not run["steps"]:
        return None
    t = run["traffic"]
    wall = run["window_s"] / len(run["steps"])
    flops = step_flops(run["config"]["model"], t["global_batch"],
                       t["seq_len"])
    return 100.0 * flops / (wall * peaks.BF16_FLOPS)

"""Plain reference of a dense decoder (the Qwen2 family, arXiv:2407.10671).

Pre-norm blocks of RMSNorm, grouped-query causal attention with biased
Q/K/V projections and rotary positions (the two halves of each head
rotated, base ``rope_theta``), RMSNorm, and a SwiGLU MLP
``(silu(x W_in) * x W_gate) W_out``; a final RMSNorm and logits from the
tied embedding; the loss is the token-mean cross entropy.  Query head
``h`` reads key/value head ``h // (num_heads / num_kv_heads)``.

Float32 throughout; each layer is recomputed in the backward pass
(``torch.utils.checkpoint``) and the attention runs in query blocks
that read only the keys up to their end, so that a row of 8,192
positions fits the card.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import Precision, nll_sum, rms_norm

QUERY_BLOCK = 1024


def padded_vocab(m: dict, layout: dict) -> int:
    k = layout["vocab_pad_multiple"]
    return -(-m["vocab_size"] // k) * k


def shapes(m: dict, layout: dict) -> dict[str, tuple]:
    """Every leaf's path and shape; layers stacked on a leading axis."""
    n, d, hq, hkv, hd, ff = (m["num_layers"], m["d_model"], m["num_heads"],
                             m["num_kv_heads"], m["head_dim"], m["d_ff"])
    out = {"embed.embed": (padded_vocab(m, layout), d),
           "final_norm.scale": (d,),
           "blocks.0.norm1.scale": (n, d),
           "blocks.0.attn.wq": (n, d, hq, hd),
           "blocks.0.attn.wk": (n, d, hkv, hd),
           "blocks.0.attn.wv": (n, d, hkv, hd),
           "blocks.0.attn.wo": (n, hq, hd, d)}
    if m.get("attn_bias"):
        out.update({"blocks.0.attn.bq": (n, hq, hd),
                    "blocks.0.attn.bk": (n, hkv, hd),
                    "blocks.0.attn.bv": (n, hkv, hd)})
    out.update({"blocks.0.norm2.scale": (n, d),
                "blocks.0.mlp.w_in": (n, d, ff),
                "blocks.0.mlp.w_gate": (n, d, ff),
                "blocks.0.mlp.w_out": (n, ff, d)})
    return out


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal softmax attention, q (B, S, Hq, D) over k/v (B, S, Hkv, D)."""
    b, s, hq, hd = q.shape
    g = hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)     # (B, Hq, S, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for i0 in range(0, s, QUERY_BLOCK):
        i1 = min(s, i0 + QUERY_BLOCK)
        scores = q[:, :, i0:i1] @ k[:, :, :i1].transpose(-1, -2) \
            * hd ** -0.5
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        kj = torch.arange(i1, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi, float("-inf"))
        out.append(torch.softmax(scores, -1) @ v[:, :, :i1])
    return torch.cat(out, dim=2).transpose(1, 2)          # (B, S, Hq, D)


def _block(x, p: dict, m: dict, prec: Precision):
    d, hq, hkv, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    eps = m["norm_eps"]
    h = rms_norm(x, p["norm1.scale"], eps)
    q = prec.linear(h, p["attn.wq"].reshape(d, hq * hd))
    k = prec.linear(h, p["attn.wk"].reshape(d, hkv * hd))
    v = prec.linear(h, p["attn.wv"].reshape(d, hkv * hd))
    if "attn.bq" in p:
        q = q + p["attn.bq"].reshape(-1)
        k = k + p["attn.bk"].reshape(-1)
        v = v + p["attn.bv"].reshape(-1)
    shape = x.shape[:2]
    q = _rope(q.reshape(*shape, hq, hd), m["rope_theta"])
    k = _rope(k.reshape(*shape, hkv, hd), m["rope_theta"])
    o = prec.act(_attention(q, k, v.reshape(*shape, hkv, hd)))
    x = prec.act(x + prec.linear(o.reshape(*shape, hq * hd),
                                 p["attn.wo"].reshape(hq * hd, d)))
    h = rms_norm(x, p["norm2.scale"], eps)
    a = prec.act(torch.nn.functional.silu(prec.linear(h, p["mlp.w_in"]))
                 * prec.linear(h, p["mlp.w_gate"]))
    return prec.act(x + prec.linear(a, p["mlp.w_out"]))


def loss_sum(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             m: dict, prec: Precision) -> torch.Tensor:
    """Summed cross entropy of ``labels`` after ``tokens`` (B, S)."""
    embed = params["embed.embed"]
    x = prec.act(embed[tokens])
    layers = [{k[len("blocks.0."):]: v[i] for k, v in params.items()
               if k.startswith("blocks.0.")}
              for i in range(m["num_layers"])]
    for p in layers:
        x = checkpoint(_block, x, p, m, prec, use_reentrant=False)
    x = rms_norm(x, params["final_norm.scale"], m["norm_eps"])
    logits = prec.linear(x, embed[:m["vocab_size"]].T)
    return nll_sum(logits, labels)

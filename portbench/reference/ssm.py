"""Plain reference of an attention-free Mamba-2 stack (arXiv:2405.21060).

Each layer is ``x + Mamba2(RMSNorm(x))``; the Mamba-2 block projects to
``[z, xBC, dt]``, runs a depthwise causal convolution (kernel
``ssm_conv``) and SiLU over ``xBC``, splits it into x (heads of
``ssm_head_dim``), B and C (``ssm_ngroups`` groups of ``ssm_state``),
takes ``dt = softplus(dt + dt_bias)`` and ``A = -exp(A_log)``, and runs
the selective state space

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,    y_t = C_t^T h_t + D x_t,

then ``RMSNorm(y * silu(z)) W_out``.  A final RMSNorm and logits from
the tied embedding; the loss is the token-mean cross entropy.

The scan is the paper's chunked dual form written out plainly (the
"minimal SSD" of the Mamba-2 paper): within a chunk the masked decay
matrix exp(segsum(dt A)) applied to C B^T, across chunks the chunk
states carried by the same decay.  Float32 throughout, each layer
recomputed in the backward pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import Precision, nll_sum, rms_norm
from portbench.reference.dense import padded_vocab


def _dims(m: dict) -> tuple[int, int, int, int, int]:
    di = m["ssm_expand"] * m["d_model"]
    return di, m["ssm_ngroups"], m["ssm_state"], di // m["ssm_head_dim"], \
        m["ssm_head_dim"]


def shapes(m: dict, layout: dict) -> dict[str, tuple]:
    n, d = m["num_layers"], m["d_model"]
    di, g, st, h, _ = _dims(m)
    conv = di + 2 * g * st
    return {"embed.embed": (padded_vocab(m, layout), d),
            "final_norm.scale": (d,),
            "blocks.0.norm1.scale": (n, d),
            "blocks.0.ssm.in_proj": (n, d, 2 * di + 2 * g * st + h),
            "blocks.0.ssm.conv_w": (n, m["ssm_conv"], conv),
            "blocks.0.ssm.conv_b": (n, conv),
            "blocks.0.ssm.A_log": (n, h),
            "blocks.0.ssm.dt_bias": (n, h),
            "blocks.0.ssm.D": (n, h),
            "blocks.0.ssm.norm_scale": (n, di),
            "blocks.0.ssm.out_proj": (n, di, d)}


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q): [i, j] = x[j+1] + ... + x[i] for i >= j,
    -inf above the diagonal."""
    q = x.shape[-1]
    xx = x[..., None].expand(*x.shape, q)
    low = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device),
                     -1)
    xx = xx.masked_fill(~low, 0.0)
    out = torch.cumsum(xx, dim=-2)
    keep = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int):
    """x (b, l, h, p), dt (b, l, h), A (h,), B/C (b, l, h, n) -> y (b, l,
    h, p), from a zero state."""
    b, l, h, p = x.shape
    c, q = l // chunk, chunk
    xs = (x * dt[..., None]).reshape(b, c, q, h, p)
    a = (dt * A).reshape(b, c, q, h).permute(0, 3, 1, 2)     # (b, h, c, q)
    B = B.reshape(b, c, q, h, -1)
    C = C.reshape(b, c, q, h, -1)
    a_cum = torch.cumsum(a, dim=-1)
    decay = torch.exp(_segsum(a))                           # (b,h,c,q,q)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, decay,
                          xs)
    to_end = torch.exp(a_cum[..., -1:] - a_cum)              # (b,h,c,q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, to_end, xs)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(b, l, h, p)


def _block(x, p: dict, m: dict, prec: Precision):
    di, g, st, h, hp = _dims(m)
    eps = m["norm_eps"]
    u = rms_norm(x, p["norm1.scale"], eps)
    zxbcdt = prec.linear(u, p["ssm.in_proj"])
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * st, h], dim=-1)
    k = m["ssm_conv"]
    w = p["ssm.conv_w"].T[:, None, :]                       # (ch, 1, k)
    xbc = F.conv1d(xbc.transpose(1, 2), w, p["ssm.conv_b"], padding=k - 1,
                   groups=w.shape[0])[..., :x.shape[1]].transpose(1, 2)
    xbc = prec.act(F.silu(xbc))
    xs, Bg, Cg = xbc.split([di, g * st, g * st], dim=-1)
    b, l = x.shape[:2]
    heads_per_group = h // g
    Bh = Bg.reshape(b, l, g, st).repeat_interleave(heads_per_group, dim=2)
    Ch = Cg.reshape(b, l, g, st).repeat_interleave(heads_per_group, dim=2)
    dt = F.softplus(dt + p["ssm.dt_bias"])
    A = -torch.exp(p["ssm.A_log"])
    xh = xs.reshape(b, l, h, hp)
    y = ssd(xh, dt, A, Bh, Ch, m["ssm_chunk"]) \
        + xh * p["ssm.D"][:, None]
    y = y.reshape(b, l, di) * F.silu(z)
    y = prec.act(rms_norm(prec.act(y), p["ssm.norm_scale"], eps))
    return prec.act(x + prec.linear(y, p["ssm.out_proj"]))


def loss_sum(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
             m: dict, prec: Precision) -> torch.Tensor:
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

"""Mamba-2 block: state-space duality (SSD), chunked matmul formulation.

[arXiv:2405.21060]  The SSD layer computes, per head h with state size N:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t = C_t^T h_t + D x_t

The chunked algorithm splits L into chunks of Q tokens; within a chunk
the contribution is a masked (C B^T ⊙ decay) product — the Hopper kernel
of ``repro_torch.kernels.ssd`` on the card, its plain version on the CPU
— and across chunks a short loop carries the (H, N, P) state.  With
``ssm_ngroups`` G > 1, B and C have one row per group and group ``gi``
serves the contiguous heads ``gi*H/G .. (gi+1)*H/G - 1``, as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import _dense_init
from repro_torch.sharding import logical_constraint
from repro_torch.sharding.local import on_local_shards
from repro_torch.types import Param


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             dev: torch.device) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    proj_out = 2 * di + 2 * g * n + h
    conv_w = torch.randn((cfg.ssm_conv, _conv_channels(cfg)), generator=gen,
                         device=dev) / math.sqrt(cfg.ssm_conv)
    return {
        "in_proj": Param(_dense_init(gen, (d, proj_out), d, dev),
                         ("embed", "ssm_inner")),
        "conv_w": Param(conv_w, ("conv", "ssm_inner")),
        "conv_b": Param(torch.zeros(_conv_channels(cfg), device=dev),
                        ("ssm_inner",)),
        "A_log": Param(torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
                       ("ssm_heads",)),
        "dt_bias": Param(torch.zeros(h, device=dev), ("ssm_heads",)),
        "D": Param(torch.ones(h, device=dev), ("ssm_heads",)),
        "norm_scale": Param(torch.ones(di, device=dev), ("ssm_inner",)),
        "out_proj": Param(_dense_init(gen, (di, d), di, dev),
                          ("ssm_inner", "embed")),
    }


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(y + b)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d. x (B, L, C); w (K, C).  On DTensors it
    runs on batch and channel shards, the sequence whole (DTensor's own
    pad fails to plan its redistribution on a 2-D mesh in torch 2.11)."""
    return on_local_shards(_causal_conv_local, (x, w, b),
                           ((0, 2), (None, 1), (None, 0)), ((0, 2),))


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, gn, h = cfg.ssm_d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int):
    """SSD scan in chunked (matmul) form.

    x (Bb, L, H, P); dt (Bb, L, H) [post-softplus]; A (H,) negative;
    B, C (Bb, L, G, N) with H a multiple of G; D (H,).  Returns (y (Bb,
    L, H, P), final state (Bb, H, N, P)).  The intra-chunk part is
    ``kernels.ssd.ssd_intra_chunk`` (one launch per group); the
    inter-chunk recurrence, ``y_inter`` and the D-skip run here.  On
    DTensors all of it runs on batch and head shards (a head shard
    holds its heads' groups whole where G > 1 shards with the heads;
    with one group B and C are whole on every head shard), so the
    kernels launch on the local shards."""
    bc = (0, 2) if B.shape[2] > 1 else (0, None)
    return on_local_shards(_ssd_chunked_local, (x, dt, A, B, C, D),
                           ((0, 2), (0, 2), (None, 0), bc, bc, (None, 0)),
                           ((0, 2), (0, 1)), chunk=chunk)


def _ssd_chunked_local(x, dt, A, B, C, D, *, chunk: int):
    bb, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if g == 1:
        B, C = B[:, :, 0], C[:, :, 0]
    y_intra, states, cum = ssd_ops.ssd_intra_chunk(x, dt, A, B, C,
                                                   chunk=chunk)
    nc, q = cum.shape[1], cum.shape[2]
    cc = C.reshape(bb, nc, q, g, n).to(torch.float32)

    # inter-chunk recurrence over nc (sequential, nc is small)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (Bb,nc,h)
    carry = torch.zeros((bb, h, n, p), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                  # state *before* chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (Bb,nc,h,n,p)

    # each group's C against its heads' states
    inner_decay = torch.exp(cum).reshape(bb, nc, q, g, h // g)
    y_inter = torch.einsum("bclgn,bclgh,bcghnp->bclghp", cc, inner_decay,
                           prev_states.reshape(bb, nc, g, h // g, n, p)) \
        .reshape(bb, nc, q, h, p)
    y = (y_intra + y_inter).reshape(bb, l, h, p)
    return y + x * D[None, None, :, None], carry


def apply_ssm(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              return_state: bool = False):
    """Full-sequence Mamba-2 block. x (B, L, d) -> (B, L, d) [, cache]."""
    dt_ = x.dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xbc_raw, dtraw = _split_proj(zxbcdt, cfg)
    xbc = _causal_conv(xbc_raw, params["conv_w"].to(dt_),
                       params["conv_b"].to(dt_))
    di, g, n = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
    xs = xbc[..., :di]
    B = xbc[..., di:di + g * n].reshape(*xbc.shape[:2], g, n)
    C = xbc[..., di + g * n:].reshape(*xbc.shape[:2], g, n)
    h, p = cfg.ssm_nheads, cfg.ssm_head_dim
    xh = xs.reshape(*xs.shape[:2], h, p)
    xh = logical_constraint(xh, "act_batch", "act_seq", "act_heads", None)
    dt = F.softplus(dtraw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(
        xh.to(torch.float32), dt, A, B.to(torch.float32),
        C.to(torch.float32), params["D"], chunk=cfg.ssm_chunk)
    # heads whole across the merge (and its gradient's split): a shard
    # of d_inner need not hold whole heads
    y = logical_constraint(y.reshape(*xs.shape[:2], di),
                           "act_batch", "act_seq", None).to(dt_)
    # gated RMSNorm (mamba-2)
    y = y * F.silu(z)
    yf = y.to(torch.float32)
    ms = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + cfg.norm_eps) * params["norm_scale"]).to(dt_)
    out = y @ params["out_proj"].to(dt_)
    if return_state:
        k = cfg.ssm_conv
        if xbc_raw.shape[1] >= k - 1:
            conv_tail = xbc_raw[:, xbc_raw.shape[1] - (k - 1):, :]
        else:
            conv_tail = F.pad(xbc_raw, (0, 0, k - 1 - xbc_raw.shape[1], 0))
        cache = {"conv": conv_tail.to(torch.bfloat16),
                 "state": final_state.to(torch.float32)}
        return out, cache
    return out


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    h, n, p = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_head_dim
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, _conv_channels(cfg)),
                                dtype=torch.bfloat16, device=device),
            "state": torch.zeros((batch, h, n, p), dtype=torch.float32,
                                 device=device)}


def ssm_cache_axes() -> dict:
    return {"conv": ("act_batch", None, "act_ssm_inner"),
            "state": ("act_batch", "act_heads", None, None)}


def apply_ssm_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict):
    """Single-token step. x (B, 1, d) -> (y (B, 1, d), new_cache)."""
    dt_ = x.dtype
    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xbc_new, dtraw = _split_proj(zxbcdt[:, 0, :], cfg)
    # conv over the rolling buffer
    conv_w = params["conv_w"].to(dt_)
    hist = torch.cat([cache["conv"].to(dt_), xbc_new[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist, conv_w) \
        + params["conv_b"].to(dt_)
    xbc = F.silu(conv_out)
    new_conv = hist[:, 1:, :].to(cache["conv"].dtype)

    di, g, n = cfg.ssm_d_inner, cfg.ssm_ngroups, cfg.ssm_state
    h, p = cfg.ssm_nheads, cfg.ssm_head_dim
    xs = xbc[..., :di].reshape(-1, h, p).to(torch.float32)
    B = xbc[..., di:di + g * n].reshape(-1, g, n).to(torch.float32)
    C = xbc[..., di + g * n:].reshape(-1, g, n).to(torch.float32)
    dt = F.softplus(dtraw.to(torch.float32) + params["dt_bias"])   # (B,h)
    A = -torch.exp(params["A_log"])
    da = torch.exp(dt * A)                                          # (B,h)
    hg = h // g
    Bh = B.repeat_interleave(hg, dim=1)                             # (B,h,n)
    Ch = C.repeat_interleave(hg, dim=1)
    new_state = (cache["state"] * da[..., None, None]
                 + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, xs))
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state) \
        + xs * params["D"][None, :, None]
    y = y.reshape(-1, di).to(dt_) * F.silu(z)
    yf = y.to(torch.float32)
    ms = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + cfg.norm_eps) * params["norm_scale"]).to(dt_)
    out = y @ params["out_proj"].to(dt_)
    return out[:, None, :], {"conv": new_conv, "state": new_state}

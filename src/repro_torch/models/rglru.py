"""RG-LRU recurrent block (Griffin / recurrentgemma).

[arXiv:2402.19427]  The recurrent block is:

    y  = W_out( RG-LRU(conv1d(W_x x)) * gelu(W_y x) )

and the Real-Gated Linear Recurrent Unit itself, per channel:

    r_t = sigmoid(W_a u_t + b_a)           (recurrence gate)
    i_t = sigmoid(W_i u_t + b_i)           (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  with c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The full-sequence path computes the linear recurrence with a log-depth
doubling scan over the sequence (Hillis–Steele: 12 steps for 2560
tokens, each a few elementwise launches over the whole (B, L, w)
tensor), where the reference uses ``jax.lax.associative_scan``; both
sum in fp32 but in a different order, so they agree to a tolerance,
not bit for bit.  Decode is a single fused step.  Gate projections are
full (w, w) matrices, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init
from repro_torch.sharding import logical_constraint
from repro_torch.types import Param

RGLRU_C = 8.0


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               dev: torch.device) -> dict:
    d, w = cfg.d_model, cfg.rglru_width or cfg.d_model
    # Lambda init so that a = exp(-c*softplus(L)) is distributed in
    # (0.9, 0.999), the Griffin init range.
    u = torch.rand(w, generator=gen, device=dev) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u ** (1.0 / RGLRU_C))))
    conv_w = torch.randn((cfg.rglru_conv, w), generator=gen, device=dev) \
        * cfg.rglru_conv ** -0.5
    return {
        "w_x": Param(_dense_init(gen, (d, w), d, dev), ("embed", "rglru")),
        "w_y": Param(_dense_init(gen, (d, w), d, dev), ("embed", "rglru")),
        "conv_w": Param(conv_w, ("conv", "rglru")),
        "conv_b": Param(torch.zeros(w, device=dev), ("rglru",)),
        "w_a": Param(_dense_init(gen, (w, w), w, dev), ("rglru_in", "rglru")),
        "b_a": Param(torch.zeros(w, device=dev), ("rglru",)),
        "w_i": Param(_dense_init(gen, (w, w), w, dev), ("rglru_in", "rglru")),
        "b_i": Param(torch.zeros(w, device=dev), ("rglru",)),
        "lam": Param(lam, ("rglru",)),
        "w_out": Param(_dense_init(gen, (w, d), w, dev), ("rglru", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d (no activation). x (B, L, C); w (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k)) + b


def _gates(params, u: torch.Tensor):
    """u (..., w) -> (a, gated_input), both fp32."""
    uf = u.to(torch.float32)
    r = torch.sigmoid(uf @ params["w_a"].to(torch.float32) + params["b_a"])
    i = torch.sigmoid(uf @ params["w_i"].to(torch.float32) + params["b_i"])
    log_a = -RGLRU_C * F.softplus(params["lam"]) * r           # <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalisation (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * uf)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over axis 1 of (B, L,
    ...) tensors: log2(L) doubling steps, each composing every position
    with the one ``d`` before it (the associative combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``)."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(params, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence RG-LRU. u (B, L, w) -> (B, L, w) recurrence in u's
    dtype."""
    a, b = _gates(params, u)
    return linear_scan(a, b).to(u.dtype)


def rglru_step(params, u: torch.Tensor, h_prev: torch.Tensor):
    """Single decode step. u (B, w); h_prev (B, w) fp32 -> (y, h_new)."""
    a, b = _gates(params, u)
    h = a * h_prev + b
    return h.to(u.dtype), h


def apply_rglru(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """Full recurrent block. x (B, L, d) -> (B, L, d) [, cache]."""
    dt = x.dtype
    gate = _gelu(x @ params["w_y"].to(dt))
    u_raw = x @ params["w_x"].to(dt)
    u = _causal_conv(u_raw, params["conv_w"].to(dt), params["conv_b"].to(dt))
    u = logical_constraint(u, "act_batch", "act_seq", "act_rglru")
    a, b = _gates(params, u)
    h_all = linear_scan(a, b)
    y = h_all.to(dt) * gate
    y = logical_constraint(y, "act_batch", "act_seq", "act_rglru")
    out = y @ params["w_out"].to(dt)
    if return_state:
        k = cfg.rglru_conv
        if u_raw.shape[1] >= k - 1:
            tail = u_raw[:, u_raw.shape[1] - (k - 1):, :]
        else:
            tail = F.pad(u_raw, (0, 0, k - 1 - u_raw.shape[1], 0))
        # the conv tail is kept in bf16 whatever the compute dtype
        cache = {"conv": tail.to(torch.bfloat16),
                 "h": h_all[:, -1, :].to(torch.float32)}
        return out, cache
    return out


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_rglru_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    w = cfg.rglru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.rglru_conv - 1, w),
                                dtype=torch.bfloat16, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


def rglru_cache_axes() -> dict:
    return {"conv": ("act_batch", None, "act_rglru"),
            "h": ("act_batch", "act_rglru")}


def apply_rglru_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: dict):
    """One-token step. x (B, 1, d) -> (y (B, 1, d), new_cache)."""
    dt = x.dtype
    x0 = x[:, 0, :]
    gate = _gelu(x0 @ params["w_y"].to(dt))
    u_new = x0 @ params["w_x"].to(dt)                           # (B, w)
    hist = torch.cat([cache["conv"].to(dt), u_new[:, None, :]], dim=1)
    u = torch.einsum("bkc,kc->bc", hist, params["conv_w"].to(dt)) \
        + params["conv_b"].to(dt)
    y, h_new = rglru_step(params, u, cache["h"])
    out = (y * gate) @ params["w_out"].to(dt)
    new_cache = {"conv": hist[:, 1:, :].to(cache["conv"].dtype), "h": h_new}
    return out[:, None, :], new_cache

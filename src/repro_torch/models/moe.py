"""Top-k mixture-of-experts FFN (Mixtral / Grok-1 style).

The reference's function (``repro.models.moe.apply_moe``): tokens are
grouped (groups of ``MOE_GROUP`` when the token count is a larger
multiple of it, else one group of all tokens), each group routes its
tokens into per-expert capacity slots — k = 0 choices before k = 1
choices, in token order (GShard) — and a token-choice past its expert's
capacity is dropped.  The reference dispatches and combines with dense
one-hot einsums over (tokens, k, experts, capacity); the port goes by
index instead: a gather of each kept token into its slot and a weighted
scatter back.  Both give the same values — a slot holds one token or
zeros, and the combine sums a token's k terms in fp32 before its one
rounding — without the one-hot, which at a group of 8,400 tokens of
mixtral-8x7b would be 706 MB and ~1.4 PFLOP a layer.

The expert products run over the whole (groups, experts, capacity, d)
slot tensor, its empty slots included, one expert at a time (each
expert's weights cast to the compute dtype as it is used, so a layer
never holds a second copy of all its experts).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, _dense_init
from repro_torch.types import Param

MOE_GROUP = 512  # tokens per routing group


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": Param(_dense_init(gen, (d, e), d), ("embed", "experts")),
        "w_in": Param(_dense_init(gen, (e, d, ff), d),
                      ("experts", "embed", "mlp")),
        "w_gate": Param(_dense_init(gen, (e, d, ff), d),
                        ("experts", "embed", "mlp")),
        "w_out": Param(_dense_init(gen, (e, ff, d), ff),
                       ("experts", "mlp", "embed")),
    }


def _capacity(group_size: int, cfg: ModelConfig) -> int:
    c = int(group_size * cfg.num_experts_per_tok * cfg.moe_capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def group_size(tokens: int) -> int:
    """Tokens per routing group for ``tokens`` routed together."""
    return MOE_GROUP if tokens % MOE_GROUP == 0 and tokens > MOE_GROUP \
        else tokens


class Routing(NamedTuple):
    """One routing of (g, t) tokens, each (g, t, k): the chosen experts
    (ties to the lower index), their renormalised fp32 gates, each
    choice's slot in its expert's queue and whether it fits the
    capacity."""
    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    fits: torch.Tensor


def route(probs: torch.Tensor, cfg: ModelConfig, capacity: int) -> Routing:
    """Route fp32 router probabilities (g, t, E): top-k with ties to the
    lower expert index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none), the k gates renormalised, and each choice's
    position counted with integer cumsums, all k = 0 choices of a group
    before its k = 1 choices."""
    g, t, e = probs.shape
    k = cfg.num_experts_per_tok
    # a stable descending sort keeps equal probabilities in index order
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = order.values[..., :k], order.indices[..., :k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert.transpose(1, 2).reshape(g, k * t), e)
    pos = ((onehot.cumsum(dim=1) - onehot) * onehot).sum(dim=-1)
    pos = pos.reshape(g, k, t).transpose(1, 2)           # (g, t, k)
    return Routing(expert, gate, pos, pos < capacity)


def router_probs(params: dict, xg: torch.Tensor) -> torch.Tensor:
    """Router logits in the compute dtype (xg's), softmax in fp32."""
    return torch.softmax((xg @ params["router"].to(xg.dtype))
                         .to(torch.float32), dim=-1)


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              row_groups: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) in x's dtype.  The B*S tokens are
    grouped as one stream; ``row_groups`` groups each row's S tokens on
    their own instead (a batch-1 call per row, as the reference's
    ``vmap``ped slot decode routes them)."""
    dt = x.dtype
    b, s, d = x.shape
    tokens = b * s
    group = group_size(s if row_groups else tokens)
    g = tokens // group
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    c = _capacity(group, cfg)

    xg = x.reshape(g, group, d)
    r = route(router_probs(params, xg), cfg, c)
    gate = r.gate.to(dt)
    # dispatched: fits its expert and its gate survives the cast (the
    # reference's ``combine > 0``); a choice that does not still holds
    # its slot position
    keep = (r.fits & (gate > 0)).reshape(-1)
    grp = torch.arange(g, device=x.device)[:, None, None]
    slot = ((grp * e + r.expert) * c + r.pos).reshape(-1)      # (g*t*k,)
    src = torch.arange(tokens, device=x.device).repeat_interleave(k)
    slots = x.new_zeros((g * e * c, d))
    slots[slot[keep]] = x.reshape(tokens, d)[src[keep]]
    slots = slots.view(g, e, c, d)

    act = _act(cfg.act)
    out = torch.empty_like(slots)
    for j in range(e):
        xe = slots[:, j].reshape(g * c, d)
        h = act(xe @ params["w_in"][j].to(dt)) * (xe @ params["w_gate"][j]
                                                  .to(dt))
        out[:, j] = (h @ params["w_out"][j].to(dt)).view(g, c, d)
    del slots

    # weighted scatter back: each token's kept choices, summed in fp32
    picked = out.view(g * e * c, d)[slot.clamp_max(g * e * c - 1)]
    w = torch.where(keep, gate.reshape(-1).to(torch.float32), 0.0)
    y = (picked.to(torch.float32) * w[:, None]).view(tokens, k, d).sum(1)
    return y.to(dt).reshape(b, s, d)


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob * mean assignment
    fraction), over the first choice of each token."""
    e = cfg.num_experts
    onehot = F.one_hot(expert_idx[..., 0], e).to(torch.float32)
    frac = onehot.reshape(-1, e).mean(dim=0)
    mean_prob = probs.to(torch.float32).reshape(-1, e).mean(dim=0)
    return e * (frac * mean_prob).sum()

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

Routing groups are independent, so on DTensors the routing, the
dispatch and the combine run on each device's shard of the groups
(``sharding.local.on_local_shards``): DTensor has no sharding of a
gather or scatter by computed index.  The expert products stay DTensor
products, so their weight gathers are a traced step's collectives.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, _dense_init
from repro_torch.sharding import logical_constraint
from repro_torch.sharding.local import on_local_shards
from repro_torch.types import Param

MOE_GROUP = 512  # tokens per routing group


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dev: torch.device) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": Param(_dense_init(gen, (d, e), d, dev),
                        ("embed", "experts")),
        "w_in": Param(_dense_init(gen, (e, d, ff), d, dev),
                      ("experts", "embed", "mlp")),
        "w_gate": Param(_dense_init(gen, (e, d, ff), d, dev),
                        ("experts", "embed", "mlp")),
        "w_out": Param(_dense_init(gen, (e, ff, d), ff, dev),
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


def _dispatch(xg: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
              capacity: int):
    """Route (g, t) tokens xg (g, t, d) by their probabilities and
    gather each dispatched choice into its expert's capacity slot.
    Returns (slots (g, E, capacity, d), zeros where no token landed;
    each choice's slot index (g, t*k) into its own group's E*capacity
    slots, so the indices hold on any shard of the groups; its fp32
    combine weight (g, t*k), 0 where it was dropped)."""
    g, t, d = xg.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    r = route(probs, cfg, capacity)
    gate = r.gate.to(xg.dtype)
    # dispatched: fits its expert and its gate survives the cast (the
    # reference's ``combine > 0``); a choice that does not still holds
    # its slot position
    keep = r.fits & (gate > 0)
    slot = r.expert * capacity + r.pos                       # (g, t, k)
    per_group = e * capacity
    grp = torch.arange(g, device=xg.device)[:, None, None]
    n = g * per_group
    # every choice is written: a dropped one to a spare row past the end
    slots = xg.new_zeros((n + 1, d))
    slots[torch.where(keep, grp * per_group + slot, n).reshape(-1)] = \
        xg.reshape(g * t, d).repeat_interleave(k, dim=0)
    w = torch.where(keep, gate.to(torch.float32), 0.0)
    return (slots[:n].view(g, e, capacity, d),
            slot.clamp_max(per_group - 1).reshape(g, t * k),
            w.reshape(g, t * k))


def _combine(out: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
             k: int) -> torch.Tensor:
    """Weighted scatter back: each token's k choices picked from its
    group's expert outputs ``out`` (g, E, c, d) at ``slot`` (g, t*k) and
    summed in fp32 with their weights ``w``, rounded once -> (g, t, d)."""
    g, e, c, d = out.shape
    grp = torch.arange(g, device=out.device)[:, None]
    picked = out.reshape(g * e * c, d)[(grp * (e * c) + slot).reshape(-1)]
    y = (picked.to(torch.float32) * w.reshape(-1)[:, None]) \
        .view(g, -1, k, d).sum(2)
    return y.to(out.dtype)


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

    xg = logical_constraint(x.reshape(g, group, d),
                            "act_batch", None, "act_embed")
    slots, slot, w = on_local_shards(
        _dispatch, (xg, router_probs(params, xg)), ((0,), (0,)),
        ((0,), (0,), (0,)), cfg=cfg, capacity=c)
    slots = logical_constraint(slots, "act_batch", "act_experts", None,
                               "act_embed")

    act = _act(cfg.act)
    outs = []
    for j in range(e):
        # contiguous, so each product is one matrix product over the
        # groups (on a strided view matmul takes bmm with the weight
        # expanded, read again for every group)
        xe = slots[:, j].contiguous()                        # (g, c, d)
        h = act(xe @ params["w_in"][j].to(dt)) * (xe @ params["w_gate"][j]
                                                  .to(dt))
        h = logical_constraint(h, "act_batch", None, "act_mlp")
        outs.append(h @ params["w_out"][j].to(dt))
    del slots
    out = torch.stack(outs, dim=1)                           # (g, E, c, d)
    del outs
    y = on_local_shards(_combine, (out, slot, w), ((0,),) * 3, ((0,),), k=k)
    return y.reshape(b, s, d)


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch-style auxiliary loss (mean prob * mean assignment
    fraction), over the first choice of each token."""
    e = cfg.num_experts
    onehot = F.one_hot(expert_idx[..., 0], e).to(torch.float32)
    frac = onehot.reshape(-1, e).mean(dim=0)
    mean_prob = probs.to(torch.float32).reshape(-1, e).mean(dim=0)
    return e * (frac * mean_prob).sum()

"""Shared model building blocks: norms, RoPE, MLPs, embeddings.

All modules are plain functions over explicit parameter trees.  Compute
happens in ``cfg.dtype`` (bf16 by default) with fp32 accumulations where
it matters (norm statistics, logits); parameters are kept in fp32 and
cast to the compute type at use, at the reference's cast points.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.sharding import logical_constraint
from repro_torch.sharding.local import on_local_shards
from repro_torch.types import Param

VOCAB_PAD_MULTIPLE = 128  # the reference's pad (TPU lane width)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def padded_vocab(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab_size, VOCAB_PAD_MULTIPLE)


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
# Every initialiser takes the device its tensors are made on: the
# generator's own, or ``meta`` (shapes and dtypes without storage, the
# dry-run's abstract parameters) drawn from a CPU generator, since
# ``torch.Generator(device="meta")`` does not exist.
def _dense_init(gen: torch.Generator, shape, in_axis_size,
                dev: torch.device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    # scaled in place: one full-size temporary fewer at init
    return torch.randn(shape, generator=gen, device=dev).mul_(scale)


def init_norm(cfg: ModelConfig, device) -> dict:
    p = {"scale": Param(torch.ones(cfg.d_model, device=device), ("norm",))}
    if cfg.use_layer_norm:
        p["bias"] = Param(torch.zeros(cfg.d_model, device=device), ("norm",))
    return p


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.use_layer_norm:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"] + params["bias"]
    else:  # RMSNorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * params["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings (fraction < 1 => partial rotary on the leading dims)
# --------------------------------------------------------------------------
def rope_dim(cfg: ModelConfig) -> int:
    d = int(cfg.head_dim * cfg.rope_fraction)
    return d - (d % 2)


def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions (...,) -> fp32 cos/sin of shape (..., dim//2)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq).  Half-split rotation (the two halves of the first
    ``rope_dim`` dims), computed in fp32 and cast back."""
    rd = rope_dim(cfg)
    if rd == 0:
        return x
    cos, sin = rope_angles(positions, rd, cfg.rope_theta)
    cos = cos[..., None, :]  # (..., seq, 1, rd//2)
    sin = sin[..., None, :]
    rot, rest = x[..., :rd], x[..., rd:]
    x1, x2 = rot[..., :rd // 2], rot[..., rd // 2:]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), rest], dim=-1)


# --------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain 2-matrix)
# --------------------------------------------------------------------------
def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "relu": F.relu,
            "gelu": lambda h: F.gelu(h, approximate="tanh")}[name]


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             dev: torch.device) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_in": Param(_dense_init(gen, (d, ff), d, dev), ("embed", "mlp")),
         "w_out": Param(_dense_init(gen, (ff, d), ff, dev),
                        ("mlp", "embed"))}
    if cfg.gated_mlp:
        p["w_gate"] = Param(_dense_init(gen, (d, ff), d, dev),
                            ("embed", "mlp"))
    if not cfg.gated_mlp and cfg.attn_bias:  # whisper-style biased MLP
        p["b_in"] = Param(torch.zeros(ff, device=dev), ("mlp",))
        p["b_out"] = Param(torch.zeros(d, device=dev), ("norm",))
    return p


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    if "b_in" in params:
        h = h + params["b_in"].to(dt)
    h = _act(cfg.act)(h)
    if cfg.gated_mlp:
        h = h * (x @ params["w_gate"].to(dt))
    h = logical_constraint(h, "act_batch", "act_seq", "act_mlp")
    out = h @ params["w_out"].to(dt)
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def init_embeddings(gen: torch.Generator, cfg: ModelConfig,
                    dev: torch.device) -> dict:
    v, d = padded_vocab(cfg), cfg.d_model
    p = {"embed": Param(_dense_init(gen, (v, d), d, dev),
                        ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["unembed"] = Param(_dense_init(gen, (d, v), d, dev),
                             ("embed", "vocab"))
    return p


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    dt = compute_dtype(cfg)
    # gather, then cast the rows; F.embedding's backward sums the rows'
    # gradients by sorting the tokens (deterministic on CUDA), where an
    # index's backward accumulates with atomics.  A DTensor table is first
    # gathered over its d_model shards (FSDP), its vocab left sharded
    table = logical_constraint(params["embed"], "vocab", None)
    if type(table) is torch.Tensor:
        x = F.embedding(tokens, table)
    else:
        # vocab-parallel lookup: each vocab shard gives its own tokens'
        # rows and zeros for the others, a partial sum over the shards
        # (DTensor's own lookup gives a masked partial, whose gradient
        # cannot be redistributed from a plain partial sum)
        x = on_local_shards(_embed_local, (tokens, table),
                            ((0, None), (None, 0)), ((0, "sum"),),
                            lo=_row_offset(table))
    x = x.to(dt)
    if cfg.family == "hybrid":  # gemma-style sqrt(d) scale, in dt
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return logical_constraint(x, "act_batch", "act_seq", "act_embed")


def _embed_local(tokens: torch.Tensor, table: torch.Tensor, lo: int
                 ) -> torch.Tensor:
    """Rows of the table shard that starts at vocab row ``lo``, zeros
    for the tokens outside it."""
    rel = tokens.to(torch.int64) - lo
    inside = (rel >= 0) & (rel < table.shape[0])
    x = F.embedding(rel.clamp(0, table.shape[0] - 1), table)
    return torch.where(inside[..., None], x, 0.0)


def _row_offset(table) -> int:
    """The first vocab row of this device's shard of a DTensor table
    (sharded along its vocab only where the tokens are replicated, as
    the default rules place them, so ``on_local_shards`` keeps it)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    return compute_local_shape_and_global_offset(
        table.shape, table.device_mesh, table.placements)[1][0]


def _tied_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    return x @ embed.T


def _logits(x: torch.Tensor, unembed_w: torch.Tensor) -> torch.Tensor:
    return x @ unembed_w


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Returns fp32 logits over the *padded* vocab, padding masked to
    -1e9.  On DTensors the product runs on batch and vocab shards, the
    weight cast and then gathered over its d_model shards (FSDP)."""
    dt = x.dtype
    if cfg.tie_embeddings:
        fn, w, vocab_dim = _tied_logits, params["embed"], 0
    else:
        fn, w, vocab_dim = _logits, params["unembed"], 1
    logits = on_local_shards(fn, (x, w.to(dt)),
                             ((0, None), (None, vocab_dim)),
                             ((0, x.dim() - 1),))
    logits = logits.to(torch.float32)
    logits = logical_constraint(logits, "act_batch", "act_seq", "act_vocab")
    v, vp = cfg.vocab_size, padded_vocab(cfg)
    if vp != v:
        mask = torch.arange(vp, device=logits.device) < v
        logits = torch.where(mask, logits, -1e9)
    return logits


def argmax_vocab(logits: torch.Tensor) -> torch.Tensor:
    """The first index of the largest logit over the last (vocab) dim.
    On a DTensor: the maximum, then the least index that holds it, each
    reduced over the vocab shards (DTensor's own argmax over a sharded
    dim fails where a device holds one row)."""
    if type(logits) is torch.Tensor:
        return logits.argmax(dim=-1)
    v = logits.shape[-1]
    m = logits.amax(dim=-1, keepdim=True)
    vocab = torch.arange(v, device=logits.device)
    return torch.where(logits == m, vocab, v).amin(dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE in fp32. logits (..., V) — the padded vocab, its
    padding at -1e9 from ``unembed`` — labels (...)."""
    logits = logits.to(torch.float32)
    if type(logits) is torch.Tensor:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[..., None].to(torch.int64))[..., 0]
    else:
        # vocab-parallel cross entropy on a DTensor: each vocab shard
        # reduces its own logits and picks its own labels' logits, then
        # all-reduces over the shards (DTensor would gather the whole
        # vocab for a log-sum-exp, and its gather over a sharded vocab
        # has no meta route).  The per-token sums are held sharded by
        # batch only: left to DTensor they came back split over both
        # mesh axes, and so did their gradient, which then met the
        # vocab shards in a full-vocab gather.
        def rows(t):
            return logical_constraint(t, "act_batch", "act_seq")

        m = rows(logits.detach().amax(dim=-1))
        logz = rows((logits - m[..., None]).exp().sum(-1)).log() + m
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = rows(torch.where(vocab == labels[..., None], logits,
                                0.0).sum(-1))
    return (logz - gold).mean()

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
def _dense_init(gen: torch.Generator, shape, in_axis_size) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    # scaled in place: one full-size temporary fewer at init
    return torch.randn(shape, generator=gen, device=gen.device).mul_(scale)


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


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_in": Param(_dense_init(gen, (d, ff), d), ("embed", "mlp")),
         "w_out": Param(_dense_init(gen, (ff, d), ff), ("mlp", "embed"))}
    if cfg.gated_mlp:
        p["w_gate"] = Param(_dense_init(gen, (d, ff), d), ("embed", "mlp"))
    if not cfg.gated_mlp and cfg.attn_bias:  # whisper-style biased MLP
        p["b_in"] = Param(torch.zeros(ff, device=gen.device), ("mlp",))
        p["b_out"] = Param(torch.zeros(d, device=gen.device), ("norm",))
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
    out = h @ params["w_out"].to(dt)
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def init_embeddings(gen: torch.Generator, cfg: ModelConfig) -> dict:
    v = padded_vocab(cfg)
    p = {"embed": Param(_dense_init(gen, (v, cfg.d_model), cfg.d_model),
                        ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        p["unembed"] = Param(_dense_init(gen, (cfg.d_model, v), cfg.d_model),
                             ("embed", "vocab"))
    return p


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    dt = compute_dtype(cfg)
    # gather, then cast the rows; F.embedding's backward sums the rows'
    # gradients by sorting the tokens (deterministic on CUDA), where an
    # index's backward accumulates with atomics
    x = F.embedding(tokens, params["embed"]).to(dt)
    if cfg.family == "hybrid":  # gemma-style sqrt(d) scale, in dt
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Returns fp32 logits over the *padded* vocab, padding masked to -1e9."""
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(dt).T
    else:
        logits = x @ params["unembed"].to(dt)
    logits = logits.to(torch.float32)
    v, vp = cfg.vocab_size, padded_vocab(cfg)
    if vp != v:
        mask = torch.arange(vp, device=logits.device) < v
        logits = torch.where(mask, logits, -1e9)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE in fp32. logits (..., V) — the padded vocab, its
    padding at -1e9 from ``unembed`` — labels (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return (logz - gold).mean()

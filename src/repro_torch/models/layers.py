"""Shared model building blocks: norms, embeddings, initialisers.

All modules are plain functions over explicit parameter trees.  Compute
happens in ``cfg.dtype`` (bf16 by default) with fp32 accumulations where
it matters (norm statistics, logits); parameters are kept in fp32 and
cast to the compute type at use, at the reference's cast points.
"""
from __future__ import annotations

import math

import torch

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
    return torch.randn(shape, generator=gen, device=gen.device) * scale


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
    return params["embed"].to(compute_dtype(cfg))[tokens]


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

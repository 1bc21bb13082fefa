"""Model assembly: block stacks over a layer loop.

The reference cycles ``block_pattern`` over ``num_layers``, groups the
layers into ``num_layers // len(pattern)`` pattern groups whose
parameters are stacked on a leading ``layers`` axis and scanned, and
applies the remainder layers unrolled.  The port keeps that parameter
layout — so a reference tree converts leaf for leaf — and walks the
stacked axis with a Python loop.

The ported block kinds are ``"ssm"`` (mamba-2), ``"rec"`` (RG-LRU +
MLP) and ``"attn"`` (causal self-attention, full-context or local, +
MLP); MoE FFNs, the encoder-decoder stack, VLM inputs and int8 KV
caches raise ``NotImplementedError`` until their slices land (ROADMAP,
port queue).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.types import Param, is_param, tree_map

NEXT_SLICE = ("ROADMAP, port queue: MoE FFNs (mixtral, grok), int8 KV "
              "caches, cross-attention, encoder-decoder and VLM inputs "
              "come with later slices")
BLOCK_KINDS = ("ssm", "rec", "attn")


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet — {NEXT_SLICE}")


# --------------------------------------------------------------------------
# structure helpers
# --------------------------------------------------------------------------
def pattern_split(cfg: ModelConfig) -> tuple[tuple[str, ...], int, int]:
    """(pattern, n_full_groups, n_remainder_layers)."""
    pat = cfg.block_pattern
    n_full, rem = divmod(cfg.num_layers, len(pat))
    return pat, n_full, rem


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window or cfg.local_window


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise _unported(f"block kind {kind!r} ({cfg.name})")
    if cfg.num_experts:
        raise _unported(f"the MoE FFN ({cfg.name})")
    if cfg.is_encoder_decoder:
        raise _unported(f"the encoder-decoder stack ({cfg.name})")
    if cfg.kv_cache_dtype == "int8":
        raise _unported(f"the int8 KV cache ({cfg.name})")


# --------------------------------------------------------------------------
# per-block init / apply
# --------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dev = gen.device
    if kind == "ssm":
        return {"norm1": L.init_norm(cfg, dev),
                "ssm": ssm_mod.init_ssm(gen, cfg)}
    if kind == "rec":
        return {"norm1": L.init_norm(cfg, dev),
                "rec": rglru_mod.init_rglru(gen, cfg),
                "norm2": L.init_norm(cfg, dev),
                "mlp": L.init_mlp(gen, cfg)}
    if kind == "attn":
        return {"norm1": L.init_norm(cfg, dev),
                "attn": attn_mod.init_attention(gen, cfg),
                "norm2": L.init_norm(cfg, dev),
                "mlp": L.init_mlp(gen, cfg)}
    raise _unported(f"block kind {kind!r}")


def _mlp_residual(params, x, cfg: ModelConfig):
    return x + L.apply_mlp(params["mlp"], L.apply_norm(params["norm2"], x,
                                                       cfg), cfg)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions=None,
                collect_cache: bool = False):
    """Full-sequence block. Returns (x, cache_or_None); an attention
    block's cache is its raw (k, v) after RoPE, which ``prefill`` turns
    into the decode layout."""
    if kind not in BLOCK_KINDS:
        raise _unported(f"block kind {kind!r}")
    h = L.apply_norm(params["norm1"], x, cfg)
    cache = None
    if kind == "ssm":
        if collect_cache:
            y, cache = ssm_mod.apply_ssm(params["ssm"], h, cfg,
                                         return_state=True)
        else:
            y = ssm_mod.apply_ssm(params["ssm"], h, cfg)
        return x + y, cache
    if kind == "rec":
        if collect_cache:
            y, cache = rglru_mod.apply_rglru(params["rec"], h, cfg,
                                             return_state=True)
        else:
            y = rglru_mod.apply_rglru(params["rec"], h, cfg)
    else:
        y = attn_mod.attend(params["attn"], h, cfg, positions=positions,
                            window=_attn_window(cfg),
                            return_kv=collect_cache)
        if collect_cache:
            y, (k, v) = y
            cache = {"k": k, "v": v}
    return _mlp_residual(params, x + y, cfg), cache


def apply_block_decode(params, x, cfg: ModelConfig, kind: str, cache, t):
    """One-token block step (``t`` a scalar or one position per row).
    Returns (x, new_cache)."""
    if kind not in BLOCK_KINDS:
        raise _unported(f"block kind {kind!r}")
    h = L.apply_norm(params["norm1"], x, cfg)
    if kind == "ssm":
        y, new_cache = ssm_mod.apply_ssm_decode(params["ssm"], h, cfg, cache)
        return x + y, new_cache
    if kind == "rec":
        y, new_cache = rglru_mod.apply_rglru_decode(params["rec"], h, cfg,
                                                    cache)
    else:
        y, new_cache = attn_mod.attend_decode(params["attn"], h, cfg, cache,
                                              t, window=_attn_window(cfg))
    return _mlp_residual(params, x + y, cfg), new_cache


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def stack_trees(trees: list):
    """Per-layer trees -> one tree with the layers stacked on axis 0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def _stack_layers(gen: torch.Generator, cfg: ModelConfig, kind: str,
                  n: int) -> dict:
    """``n`` layers of one kind, initialised in order, their values
    written into preallocated stacked tensors one layer at a time (peak
    memory: the stack plus one layer, not two stacks)."""
    first = init_block(gen, cfg, kind)
    stacked = tree_map(
        lambda p: Param(p.value.new_empty((n,) + p.value.shape),
                        ("layers",) + p.axes), first, is_leaf=is_param)
    for i in range(n):
        blk = first if i == 0 else init_block(gen, cfg, kind)
        tree_map(lambda dst, src: dst.value[i].copy_(src.value), stacked,
                 blk, is_leaf=is_param)
        del blk
    return stacked


def init_params(key, cfg: ModelConfig, *, device=None) -> dict:
    """Param-wrapped model parameters, fp32, on ``device`` (``cuda`` when
    None).  ``key`` is a ``torch.Generator`` or an int seed; the numbers
    differ from ``jax.random``'s — tests carry reference weights across
    with ``repro_torch.convert.model_tree``."""
    from repro_torch.utils.env import default_device

    _check_supported(cfg)
    dev = default_device(device) if not isinstance(key, torch.Generator) \
        else key.device
    gen = _generator(key, dev)
    pattern, n_full, rem = pattern_split(cfg)
    p: dict = {"embed": L.init_embeddings(gen, cfg),
               "final_norm": L.init_norm(cfg, dev)}
    if n_full:
        p["blocks"] = tuple(_stack_layers(gen, cfg, kind, n_full)
                            for kind in pattern)
    if rem:
        p["rem"] = tuple(init_block(gen, cfg, pattern[j % len(pattern)])
                         for j in range(rem))
    return p


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------
def _run_stack(params, x, cfg: ModelConfig, pattern, *, positions=None,
               collect_cache: bool = False):
    """Walk the stacked pattern groups, then the remainder layers.

    Returns (x, caches) where caches mirrors {"blocks": tuple (stacked
    per pattern position), "rem": tuple} (entries None unless
    collect_cache)."""
    caches: dict = {}
    if "blocks" in params:
        n_layers = params["blocks"][0]["norm1"]["scale"].shape[0]
        per_pos: list[list] = [[] for _ in pattern]
        for i in range(n_layers):
            for j, kind in enumerate(pattern):
                x, c = apply_block(layer(params["blocks"][j], i), x, cfg,
                                   kind, positions=positions,
                                   collect_cache=collect_cache)
                per_pos[j].append(c)
        caches["blocks"] = tuple(stack_trees(c) if collect_cache else None
                                 for c in per_pos)
    if "rem" in params:
        rem_caches = []
        for j, blk in enumerate(params["rem"]):
            x, c = apply_block(blk, x, cfg, pattern[j % len(pattern)],
                               positions=positions,
                               collect_cache=collect_cache)
            rem_caches.append(c)
        caches["rem"] = tuple(rem_caches)
    return x, caches


def _embed_input(params, batch: dict, cfg: ModelConfig):
    """Token embedding. Returns (x, positions, n_prefix)."""
    if cfg.family == "vlm" or cfg.is_encoder_decoder:
        raise _unported(f"the {cfg.family} input stage")
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions, 0


def forward(params, batch: dict, cfg: ModelConfig, *, mode: str = "prefill"):
    """Full-sequence logits (B, S_tokens, padded_vocab) in fp32."""
    _check_supported(cfg)
    pattern, _, _ = pattern_split(cfg)
    x, positions, _ = _embed_input(params, batch, cfg)
    x, _ = _run_stack(params, x, cfg, pattern, positions=positions)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)

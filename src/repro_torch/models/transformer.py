"""Model assembly: block stacks over a layer loop.

The reference cycles ``block_pattern`` over ``num_layers``, groups the
layers into ``num_layers // len(pattern)`` pattern groups whose
parameters are stacked on a leading ``layers`` axis and scanned, and
applies the remainder layers unrolled.  The port keeps that parameter
layout — so a reference tree converts leaf for leaf — and walks the
stacked axis with a Python loop.

The ported block kinds are ``"ssm"`` (mamba-2), ``"rec"`` (RG-LRU +
MLP) and ``"attn"`` (causal self-attention, full-context or local, +
MLP or the top-k MoE FFN).  ``encdec`` (whisper) adds an encoder stack
of non-causal attention blocks over precomputed frame embeddings and a
cross-attention in each decoder layer, with absolute sinusoid positions
in place of RoPE.  ``vlm`` (internvl2) puts precomputed patch embeddings
(``batch["patches"]``) before the token embeddings; the logits of
``forward`` leave them out again.  ``forward(mode="train")`` checkpoints
each layer group when ``cfg.remat == "layer"`` (its activations are
recomputed in the backward pass), and ``loss_fn`` is the training
objective: fp32 token-mean cross entropy and accuracy.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.sharding import logical_constraint, sharding_context
from repro_torch.types import (
    Param,
    is_param,
    tree_flatten,
    tree_map,
    tree_unflatten,
)

BLOCK_KINDS = ("ssm", "rec", "attn")


def _unported(what: str):
    return NotImplementedError(
        f"{what}: the reference has the block kinds {BLOCK_KINDS} only")


# --------------------------------------------------------------------------
# structure helpers
# --------------------------------------------------------------------------
def pattern_split(cfg: ModelConfig) -> tuple[tuple[str, ...], int, int]:
    """(pattern, n_full_groups, n_remainder_layers)."""
    pat = cfg.block_pattern
    n_full, rem = divmod(cfg.num_layers, len(pat))
    return pat, n_full, rem


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embedding (whisper-style stub positions),
    fp32 (..., d) for positions (...,)."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / max(1, half - 1))
    ang = positions.to(torch.float32)[..., None] * freq
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if d % 2:
        out = torch.nn.functional.pad(out, (0, 1))
    return out


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window or cfg.local_window


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind not in BLOCK_KINDS:
            raise _unported(f"block kind {kind!r} ({cfg.name})")


# --------------------------------------------------------------------------
# per-block init / apply
# --------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               dev: torch.device, *, decoder_cross: bool = False) -> dict:
    if kind == "ssm":
        return {"norm1": L.init_norm(cfg, dev),
                "ssm": ssm_mod.init_ssm(gen, cfg, dev)}
    if kind == "rec":
        return {"norm1": L.init_norm(cfg, dev),
                "rec": rglru_mod.init_rglru(gen, cfg, dev),
                "norm2": L.init_norm(cfg, dev),
                "mlp": L.init_mlp(gen, cfg, dev)}
    if kind == "attn":
        p = {"norm1": L.init_norm(cfg, dev),
             "attn": attn_mod.init_attention(gen, cfg, dev),
             "norm2": L.init_norm(cfg, dev),
             "mlp": (moe_mod.init_moe(gen, cfg, dev) if cfg.num_experts
                     else L.init_mlp(gen, cfg, dev))}
        if decoder_cross:
            p["norm_x"] = L.init_norm(cfg, dev)
            p["xattn"] = attn_mod.init_attention(gen, cfg, dev)
        return p
    raise _unported(f"block kind {kind!r}")


def _mlp_residual(params, x, cfg: ModelConfig, row_groups: bool = False):
    """The FFN's residual: the MoE layer when the config has experts
    (``row_groups``: each batch row routed as its own group), else the
    dense MLP."""
    h = L.apply_norm(params["norm2"], x, cfg)
    if cfg.num_experts:
        return x + moe_mod.apply_moe(params["mlp"], h, cfg,
                                     row_groups=row_groups)
    return x + L.apply_mlp(params["mlp"], h, cfg)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, positions=None,
                causal: bool = True, enc_out=None,
                collect_cache: bool = False):
    """Full-sequence block. Returns (x, cache_or_None); an attention
    block's cache is its raw (k, v) after RoPE, which ``prefill`` turns
    into the decode layout — with a cross-attention, ``{"self": (k, v),
    "cross": the encoder output's (k, v)}``."""
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
                            causal=causal, window=_attn_window(cfg),
                            return_kv=collect_cache)
        if collect_cache:
            y, (k, v) = y
            cache = {"k": k, "v": v}
        if "xattn" in params:
            x = x + y
            hx = L.apply_norm(params["norm_x"], x, cfg)
            y = attn_mod.attend(params["xattn"], hx, cfg,
                                positions=positions, causal=False,
                                kv_src=enc_out, return_kv=collect_cache)
            if collect_cache:
                y, (kx, vx) = y
                cache = {"self": cache, "cross": {"k": kx, "v": vx}}
    return _mlp_residual(params, x + y, cfg), cache


def apply_block_decode(params, x, cfg: ModelConfig, kind: str, cache, t, *,
                       row_groups: bool = False):
    """One-token block step (``t`` a scalar or one position per row;
    ``row_groups`` routes each row's MoE tokens as a group of its own).
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
    elif "xattn" in params:
        y, new_self = attn_mod.attend_decode(params["attn"], h, cfg,
                                             cache["self"], t,
                                             window=_attn_window(cfg))
        x = x + y
        hx = L.apply_norm(params["norm_x"], x, cfg)
        y, _ = attn_mod.attend_decode(params["xattn"], hx, cfg, None, t,
                                      cross_cache=cache["cross"])
        new_cache = {"self": new_self, "cross": cache["cross"]}
    else:
        y, new_cache = attn_mod.attend_decode(params["attn"], h, cfg, cache,
                                              t, window=_attn_window(cfg))
    return _mlp_residual(params, x + y, cfg, row_groups), new_cache


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _generator(key, device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    # meta tensors are drawn from a CPU generator (no meta generator)
    return torch.Generator(device="cpu" if device.type == "meta"
                           else device).manual_seed(int(key))


def stack_trees(trees: list):
    """Per-layer trees -> one tree with the layers stacked on axis 0."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def unstack(tree) -> list:
    """Every layer of a stacked tree, as views (``torch.unbind``): in a
    backward pass the layers' gradients are stacked once, where taking
    each layer with ``layer`` would add a zero-filled stack-sized
    gradient per layer, traffic quadratic in the depth."""
    leaves, treedef = tree_flatten(tree)
    per_leaf = [t.unbind(0) for t in leaves]
    return [tree_unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(len(per_leaf[0]))]


def _stack_layers(gen: torch.Generator, cfg: ModelConfig, kind: str,
                  n: int, dev: torch.device, *,
                  decoder_cross: bool = False) -> dict:
    """``n`` layers of one kind, initialised in order, their values
    written into preallocated stacked tensors one layer at a time (peak
    memory: the stack plus one layer, not two stacks)."""
    blk = init_block(gen, cfg, kind, dev, decoder_cross=decoder_cross)
    stacked = tree_map(
        lambda p: Param(p.value.new_empty((n,) + p.value.shape),
                        ("layers",) + p.axes), blk, is_leaf=is_param)
    for i in range(n):
        if i:
            blk = init_block(gen, cfg, kind, dev,
                             decoder_cross=decoder_cross)
        tree_map(lambda dst, src: dst.value[i].copy_(src.value), stacked,
                 blk, is_leaf=is_param)
        del blk
    return stacked


def init_params(key, cfg: ModelConfig, *, device=None) -> dict:
    """Param-wrapped model parameters, fp32, on ``device`` (the
    generator's device when ``key`` is a ``torch.Generator`` and
    ``device`` is None, else ``cuda`` when None; ``"meta"`` gives shapes
    and dtypes without storage, as ``launch.specs.abstract_params``
    uses).  ``key`` is a ``torch.Generator`` or an int seed; the numbers
    differ from ``jax.random``'s — tests carry reference weights across
    with ``repro_torch.convert.model_tree``."""
    from repro_torch.utils.env import default_device

    _check_supported(cfg)
    if device is None and isinstance(key, torch.Generator):
        dev = key.device
    else:
        dev = default_device(device)
    gen = _generator(key, dev)
    pattern, n_full, rem = pattern_split(cfg)
    p: dict = {"embed": L.init_embeddings(gen, cfg, dev),
               "final_norm": L.init_norm(cfg, dev)}
    cross = cfg.is_encoder_decoder
    if n_full:
        p["blocks"] = tuple(_stack_layers(gen, cfg, kind, n_full, dev,
                                          decoder_cross=cross)
                            for kind in pattern)
    if rem:
        p["rem"] = tuple(init_block(gen, cfg, pattern[j % len(pattern)],
                                    dev, decoder_cross=cross)
                         for j in range(rem))
    if cross:
        p["encoder"] = {
            "blocks": (_stack_layers(gen, cfg, "attn",
                                     cfg.num_encoder_layers, dev),),
            "final_norm": L.init_norm(cfg, dev)}
    return p


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------
def _run_stack(params, x, cfg: ModelConfig, pattern, *, positions=None,
               causal: bool = True, enc_out=None,
               collect_cache: bool = False, remat: bool = False):
    """Walk the stacked pattern groups, then the remainder layers.

    ``remat`` (training, with gradients on) checkpoints each pattern
    group: its activations are recomputed in the backward pass, as the
    reference's ``jax.checkpoint`` around its scanned group body does
    (the remainder layers are not rematerialised there either).

    Returns (x, caches) where caches mirrors {"blocks": tuple (stacked
    per pattern position), "rem": tuple} (entries None unless
    collect_cache)."""
    caches: dict = {}
    if "blocks" in params:
        n_layers = params["blocks"][0]["norm1"]["scale"].shape[0]
        per_pos: list[list] = [[] for _ in pattern]
        blocks = [unstack(b) for b in params["blocks"]]

        def group(x, i):
            out = []
            for j, kind in enumerate(pattern):
                x, c = apply_block(blocks[j][i], x, cfg,
                                   kind, positions=positions, causal=causal,
                                   enc_out=enc_out,
                                   collect_cache=collect_cache)
                out.append(c)
            x = logical_constraint(x, "act_batch", "act_seq", "act_embed")
            return x, out

        for i in range(n_layers):
            if remat:
                # the recompute sees the forward's rules and replication
                x, group_caches = checkpoint(
                    group, x, i, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        sharding_context()))
            else:
                x, group_caches = group(x, i)
            for j, c in enumerate(group_caches):
                per_pos[j].append(c)
        caches["blocks"] = tuple(stack_trees(c) if collect_cache else None
                                 for c in per_pos)
    if "rem" in params:
        rem_caches = []
        for j, blk in enumerate(params["rem"]):
            x, c = apply_block(blk, x, cfg, pattern[j % len(pattern)],
                               positions=positions, causal=causal,
                               enc_out=enc_out,
                               collect_cache=collect_cache)
            rem_caches.append(c)
        caches["rem"] = tuple(rem_caches)
    return x, caches


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (B, T, d): the
    sinusoid added in the compute dtype, the non-causal attention
    stack, the encoder's final norm."""
    dt = L.compute_dtype(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)
    x = frames.to(dt) + _sinusoid(pos, cfg.d_model).to(dt)
    x = logical_constraint(x, "act_batch", "act_seq", "act_embed")
    x, _ = _run_stack(params["encoder"], x, cfg, ("attn",), positions=pos,
                      causal=False)
    return L.apply_norm(params["encoder"]["final_norm"], x, cfg)


def _embed_input(params, batch: dict, cfg: ModelConfig):
    """Token embedding (+ the patch prefix for vlm, the sinusoid for
    encdec).  Returns (x, positions, n_prefix): a vlm batch with
    ``"patches"`` (B, P, d) runs them, cast to the compute dtype, as the
    first P positions (``n_prefix`` = P); without, the prompt runs as
    text."""
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg)
    n_prefix = 0
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)
        n_prefix = patches.shape[1]
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.is_encoder_decoder:  # no RoPE: absolute sinusoid positions
        x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    return x, positions, n_prefix


MODES = ("prefill", "train")


def forward(params, batch: dict, cfg: ModelConfig, *, mode: str = "prefill"):
    """Full-sequence logits (B, S_tokens, padded_vocab) in fp32; an
    encdec config reads ``batch["frames"]`` (B, T, d), a vlm config
    ``batch["patches"]`` (B, P, d) if present (the logits cover the
    tokens only).  ``mode="train"`` with ``cfg.remat == "layer"``
    rematerialises each layer group in the backward pass (while
    gradients are on)."""
    _check_supported(cfg)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    pattern, _, _ = pattern_split(cfg)
    x, positions, n_prefix = _embed_input(params, batch, cfg)
    enc_out = encode(params, batch["frames"], cfg) \
        if cfg.is_encoder_decoder else None
    remat = mode == "train" and cfg.remat == "layer" \
        and torch.is_grad_enabled()
    x, _ = _run_stack(params, x, cfg, pattern, positions=positions,
                      enc_out=enc_out, remat=remat)
    x = L.apply_norm(params["final_norm"], x, cfg)
    if n_prefix:
        x = x[:, n_prefix:]
    return L.unembed(params["embed"], x, cfg)


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Token-mean cross entropy of ``forward(mode="train")`` against
    ``batch["labels"]``, and the metrics {"loss", "accuracy"} (the
    accuracy detached: argmax over the padded vocab)."""
    logits = forward(params, batch, cfg, mode="train")
    labels = batch["labels"].to(logits.device)
    loss = L.cross_entropy(logits, labels)
    acc = (L.argmax_vocab(logits.detach()) == labels).to(torch.float32) \
        .mean()
    return loss, {"loss": loss, "accuracy": acc}

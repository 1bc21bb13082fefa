"""State cache construction, prefill, and single-token decode.

Cache layout mirrors the parameter layout: ``{"blocks": tuple(stacked per
pattern position), "rem": tuple(per remainder layer)}``, with the layer
axis leading in ``blocks`` leaves, so the same layer loop drives both.
``init_caches`` returns ``Param``-wrapped leaves (logical axes), as the
reference does.

Cache kinds ported so far: mamba-2 — ``(B, conv_k-1, C)`` bf16 conv tail
+ ``(B, H, N, P)`` fp32 SSM state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.transformer import (
    _check_supported,
    _embed_input,
    _run_stack,
    _unported,
    apply_block_decode,
    layer,
    pattern_split,
    stack_trees,
)
from repro_torch.types import Param, tree_map
from repro_torch.utils.env import default_device


# --------------------------------------------------------------------------
# cache init
# --------------------------------------------------------------------------
def _layer_cache(cfg: ModelConfig, kind: str, batch: int, *, device) -> dict:
    if kind != "ssm":
        raise _unported(f"the {kind!r} cache")
    values = ssm_mod.init_ssm_cache(cfg, batch, device=device)
    axes = ssm_mod.ssm_cache_axes()
    return {k: Param(v, axes[k]) for k, v in values.items()}


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                device=None) -> dict:
    """Param-wrapped cache tree for ``decode_step`` (strip with
    ``param_values``), on ``device`` (``cuda`` when None).  SSM caches
    do not grow with ``cache_len``; it is kept for the reference's
    signature."""
    _check_supported(cfg)
    dev = default_device(device)
    pattern, n_full, rem = pattern_split(cfg)
    caches: dict = {}
    if n_full:
        caches["blocks"] = tuple(
            {k: Param(p.value[None].expand((n_full,) + p.value.shape)
                      .contiguous(), ("layers",) + p.axes)
             for k, p in _layer_cache(cfg, kind, batch, device=dev).items()}
            for kind in pattern)
    if rem:
        caches["rem"] = tuple(
            _layer_cache(cfg, pattern[j % len(pattern)], batch, device=dev)
            for j in range(rem))
    return caches


# --------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the caches
# --------------------------------------------------------------------------
def prefill(params, batch: dict, cfg: ModelConfig, cache_len: int):
    """Run the full prompt, return (last-token logits (B, Vp), caches,
    t_next).  SSM caches come out of the stack already in decode format
    (conv tail + final state)."""
    _check_supported(cfg)
    pattern, _, _ = pattern_split(cfg)
    x, positions, _ = _embed_input(params, batch, cfg)
    x, caches = _run_stack(params, x, cfg, pattern, positions=positions,
                           collect_cache=True)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, caches, int(x.shape[1])


# --------------------------------------------------------------------------
# single-token decode
# --------------------------------------------------------------------------
def decode_step(params, caches, token: torch.Tensor, t, cfg: ModelConfig):
    """One decode step.  token (B, 1) int; t the absolute position (a
    scalar, or one per row).  Returns (logits (B, padded_vocab) fp32,
    new_caches)."""
    _check_supported(cfg)
    pattern, _, _ = pattern_split(cfg)
    x = L.embed_tokens(params["embed"], token, cfg)
    new_caches: dict = {}
    if "blocks" in caches:
        n_layers = params["blocks"][0]["norm1"]["scale"].shape[0]
        per_pos: list[list] = [[] for _ in pattern]
        for i in range(n_layers):
            for j, kind in enumerate(pattern):
                x, c = apply_block_decode(layer(params["blocks"][j], i), x,
                                          cfg, kind,
                                          layer(caches["blocks"][j], i), t)
                per_pos[j].append(c)
        new_caches["blocks"] = tuple(stack_trees(c) for c in per_pos)
    if "rem" in caches:
        rem_new = []
        for j, blk in enumerate(params["rem"]):
            x, c = apply_block_decode(blk, x, cfg, pattern[j % len(pattern)],
                                      caches["rem"][j], t)
            rem_new.append(c)
        new_caches["rem"] = tuple(rem_new)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return logits, new_caches


# --------------------------------------------------------------------------
# per-slot decode: independent positions per batch row
# --------------------------------------------------------------------------
def cache_slot_axes(caches) -> dict:
    """Per-leaf batch-axis tree for the decode cache tree: ``blocks``
    leaves are layer-stacked (layers, B, ...) so their slot axis is 1;
    ``rem`` leaves are batch-leading."""
    return {k: tree_map(lambda _, kk=k: 1 if kk == "blocks" else 0, v)
            for k, v in caches.items()}


def slot_decode_step(params, caches, tokens: torch.Tensor,
                     ts: torch.Tensor, cfg: ModelConfig):
    """One decode step with an *independent position per row*.

    ``tokens`` (B, 1), ``ts`` (B,) absolute positions.  The reference
    ``vmap``s a batch-1 ``decode_step`` over the slot axis; with the
    batch written out, every row of a ported block is already
    independent of the others (an SSM step reads no position), so the
    batch runs as one ``decode_step`` with the per-row positions.

    Returns (logits (B, padded_vocab) fp32, new_caches)."""
    return decode_step(params, caches, tokens, ts, cfg)


# --------------------------------------------------------------------------
# decode working set: the byte model behind the serving latency oracle
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DecodeWorkingSet:
    """Per-step memory working set of one decoding sequence.

    ``kv_entries`` is (window, per_token_bytes) per decoder layer —
    window 0 means the full context is live (dense attention), a
    positive window caps the rolling buffer.  ``state_bytes`` is the
    length-independent per-step read set (SSM/RG-LRU recurrent state,
    conv tails, whisper cross-attention KV).  ``weight_bytes`` is the
    streamed parameter footprint per step (every active parameter is
    read once per decoded token)."""
    weight_bytes: int
    kv_entries: tuple[tuple[int, int], ...]
    state_bytes: int

    def kv_bytes(self, tokens: int) -> int:
        """Live KV bytes read by one decode step at sequence length
        ``tokens`` (windowed layers cap at their buffer)."""
        return sum((min(tokens, w) if w else tokens) * per
                   for w, per in self.kv_entries)

    @property
    def kv_token_bytes(self) -> int:
        """Marginal KV bytes appended per decoded token."""
        return sum(per for _, per in self.kv_entries)


def decode_working_set(cfg: ModelConfig) -> DecodeWorkingSet:
    """Byte-level working set of one decode step, mirroring the cache
    layout the reference's ``init_caches`` builds for every block kind
    (the arithmetic needs no ported block)."""
    dt_bytes = L.compute_dtype(cfg).itemsize
    window = cfg.sliding_window or cfg.local_window
    kv_entries = []
    state = 0
    for kind in cfg.layer_kinds():
        if kind == "ssm":
            conv = (cfg.ssm_conv - 1) * ssm_mod._conv_channels(cfg) * 2
            ssm = cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_head_dim * 4
            state += conv + ssm
            continue
        if kind == "rec":
            w = cfg.rglru_width or cfg.d_model
            state += (cfg.rglru_conv - 1) * w * 2 + w * 4
            continue
        # attention: K + V per cached token (+ int8 scales)
        if cfg.kv_cache_dtype == "int8":
            per = 2 * cfg.num_kv_heads * (cfg.head_dim + 4)
        else:
            per = 2 * cfg.num_kv_heads * cfg.head_dim * dt_bytes
        kv_entries.append((window, per))
        if cfg.is_encoder_decoder:   # precomputed cross KV, read each step
            state += (2 * cfg.encoder_len * cfg.num_kv_heads
                      * cfg.head_dim * dt_bytes)
    return DecodeWorkingSet(
        weight_bytes=int(cfg.active_param_count() * dt_bytes),
        kv_entries=tuple(kv_entries),
        state_bytes=int(state))

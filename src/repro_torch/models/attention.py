"""Attention: GQA/MQA self-attention, full-context or sliding-window
(banded), cross-attention, KV caches.

* Prefill is causal attention through ``kernels.swa`` — the Hopper
  kernel on the card, its plain version on the CPU — over a band of
  ``window`` keys, or over every earlier key when ``window`` is 0 (the
  dense archs): full causal attention is the band ``window = S``, the
  key length.  The reference computes the same function with a
  query-chunked, banded jnp path (``repro.models.attention.attend``) and
  keeps the Pallas SWA kernel as its TPU-native form; the port runs the
  kernel.  GQA is never expanded in memory: query head ``h`` reads KV
  head ``h // group``.  In training the op is differentiable: its
  backward recomputes the probabilities in the swa backward kernel on
  the card (``kernels.swa.ops``), the reference's per-chunk
  ``jax.checkpoint`` policy.
* Decode reads a dense cache of ``cache_len`` slots written at absolute
  positions (``window`` 0) or a rolling buffer of ``min(window,
  cache_len)`` slots (slot = position mod length), with RoPE applied at
  insert time (absolute positions).  It is plain torch, as in the
  reference (no kernel there either).  Every cache (dense, rolling,
  int8 scales) is written by an elementwise select into a new buffer,
  which is local on every shard of a sequence-sharded cache, as the
  reference writes that cache.  Each batch row may sit at its
  own position.  Its probabilities and P.V are fp32 with one rounding
  of the output, as in the plain prefill, so decode reproduces the
  prefill's logits (the reference rounds the probabilities to the
  compute dtype instead, in both of its paths).
* An int8 KV cache (``kv_cache_dtype="int8"``) holds int8 values with
  an fp32 scale per (row, slot, KV head): each written K/V vector is
  quantised by its absolute maximum over the head dim (round half to
  even, clipped to +-127), and decode dequantises the whole cache to
  the compute dtype before attending, as the reference does.
* Cross-attention (the queries over an encoder output, key positions
  ``arange(T)``, no RoPE) and non-causal self-attention (the encoder)
  are plain torch in prefill and decode: the reference computes them
  outside its Pallas kernel, which is causal only.  They keep the
  decode path's rounding points (fp32 scores, softmax and P.V, one
  rounding of the output).
* Split-K decode: when the active sharding rules map ``cache_seq`` to
  mesh axes (``_splitk_shards``; grok's kv=8 cannot shard over a 16-way
  ``model`` axis), decode attends shard by shard — a partial
  softmax per shard and a small fp32 combine over the shards
  (``_attend_decode_splitk``), where a dense softmax would gather the
  whole cache every token.  It keeps the decode rounding points: fp32
  probabilities, an fp32 combine, one rounding of the output.  With no
  rule on ``cache_seq`` (one card) decode is unchanged.

Under active rules the activations carry the reference's
``logical_constraint`` annotations (no-ops on plain tensors); on
DTensors the swa op runs on the local shards
(``sharding.local.on_local_shards``), sharded by batch and head only.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swa import ops as swa_ops
from repro_torch.models.layers import _dense_init, apply_rope, compute_dtype
from repro_torch.sharding import active_rules, logical_constraint
from repro_torch.sharding.local import on_local_shards
from repro_torch.types import Param

NEG_INF = -1e30


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dev: torch.device) -> dict:
    d, nq, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": Param(_dense_init(gen, (d, nq, hd), d, dev),
                    ("embed", "heads", "head_dim")),
        "wk": Param(_dense_init(gen, (d, nkv, hd), d, dev),
                    ("embed", "kv_heads", "head_dim")),
        "wv": Param(_dense_init(gen, (d, nkv, hd), d, dev),
                    ("embed", "kv_heads", "head_dim")),
        "wo": Param(_dense_init(gen, (nq, hd, d), nq * hd, dev),
                    ("heads", "head_dim", "embed")),
    }
    if cfg.attn_bias:
        p["bq"] = Param(torch.zeros((nq, hd), device=dev), ("heads", "head_dim"))
        p["bk"] = Param(torch.zeros((nkv, hd), device=dev),
                        ("kv_heads", "head_dim"))
        p["bv"] = Param(torch.zeros((nkv, hd), device=dev),
                        ("kv_heads", "head_dim"))
    return p


def _heads_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, n, h) -> (B, S, n, h) in x's dtype.  On DTensors
    the product runs on batch and head shards: the weight, cast first,
    gathered over its d_model shards (FSDP), heads split where ``w``
    splits them."""
    return on_local_shards(_heads_local, (x, w.to(x.dtype)),
                           ((0, None), (None, 1)), ((0, 2),))


def _project_q(params, x, cfg: ModelConfig):
    q = _heads(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
    return q


def _project_kv(params, x, cfg: ModelConfig):
    k, v = _heads(x, params["wk"]), _heads(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return k, v


def _out_local(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    nq, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], nq * hd) @ wo.reshape(nq * hd, d)


def _out(params, o: torch.Tensor) -> torch.Tensor:
    """(B, S, nq, hd) @ wo (nq, hd, d) -> (B, S, d).  On DTensors by
    batch and head shards, a partial sum over the head shards."""
    return on_local_shards(_out_local, (o, params["wo"].to(o.dtype)),
                           ((0, 2), (None, 0)), ((0, "sum"),))


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _attend_plain(q, k, v, cfg: ModelConfig, valid=None) -> torch.Tensor:
    """q (B, L, nq, hd) over k/v (B, T, n_kv, hd) with GQA by grouping
    the query heads; ``valid`` (B, T) masks keys.  fp32 scores, softmax
    and P.V, the output rounded once to q's dtype.  On DTensors by batch
    and head shards."""
    return on_local_shards(_attend_plain_local, (q, k, v, valid),
                           ((0, 2), (0, 2), (0, 2), (0, None)), ((0, 2),),
                           cfg=cfg)


def _attend_plain_local(q, k, v, valid, cfg: ModelConfig) -> torch.Tensor:
    b, l, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, l, nkv, nq // nkv, hd)
    scores = torch.einsum("blkgh,btkh->bkglt", qg.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    scores = _softcap(scores, cfg.attn_logit_softcap)
    if valid is not None:
        scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkglt,btkh->blkgh", probs, v.to(torch.float32))
    return out.reshape(b, l, nq, hd).to(q.dtype)


# --------------------------------------------------------------------------
# prefill path (the SWA kernel)
# --------------------------------------------------------------------------
def attend(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
           positions: torch.Tensor, causal: bool = True, window: int = 0,
           kv_src: torch.Tensor | None = None, return_kv: bool = False):
    """Full-sequence attention (prefill, encoder, cross).

    x: (B, S, d); positions: (S,) query positions.  Causal
    self-attention (the swa op): each query sees the ``window``
    positions up to its own, or all of them when ``window`` is 0.
    ``causal=False`` sees every key; ``kv_src`` (B, T, d), an encoder
    output, gives the keys and values of a cross-attention (no RoPE,
    every key).  Returns (B, S, d) [, (k, v) after RoPE, at n_kv
    heads]."""
    q = _project_q(params, x, cfg)
    q = logical_constraint(q, "act_batch", "act_seq", "act_heads", None)
    k, v = _project_kv(params, x if kv_src is None else kv_src, cfg)
    if cfg.rope_fraction > 0 and kv_src is None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    # the reference constrains the KV heads after expanding them to the
    # query heads; the port keeps n_kv heads, on their own axis
    k = logical_constraint(k, "act_batch", "act_seq", "act_kv_heads", None)
    v = logical_constraint(v, "act_batch", "act_seq", "act_kv_heads", None)
    if kv_src is not None or not causal:
        out = _attend_plain(q, k, v, cfg)
    else:
        # full context is the band as wide as the keys: the kernel
        # computes row0 - window + 1 in int, so no sentinel width; on
        # DTensors the op runs on the batch and head shards
        out = on_local_shards(swa_ops.swa_attention, (q, k, v),
                              ((0, 2),) * 3, ((0, 2),),
                              window=window or k.shape[1],
                              scale=cfg.head_dim ** -0.5,
                              softcap=cfg.attn_logit_softcap)
    out = logical_constraint(out, "act_batch", "act_seq", "act_heads", None)
    y = _out(params, out)
    if return_kv:
        return y, (k, v)
    return y


# --------------------------------------------------------------------------
# decode path
# --------------------------------------------------------------------------
def _splitk_shards(cfg: ModelConfig, cache_len: int) -> int:
    """Split-K shard count when the cache is sequence-sharded: the
    product of the mesh axes the active rules map ``cache_seq`` to, or 0
    when there are no rules, no such axis, or ``cache_len`` does not
    divide by it (then decode stays dense, as the reference's does)."""
    r = active_rules()
    if r is None:
        return 0
    ns = 1
    for ax in r.rules.get("cache_seq", ()):
        if ax in r.mesh.axis_names:
            ns *= r.mesh_axis_size(ax)
    if ns > 1 and cache_len % ns == 0:
        return ns
    return 0


def _scores_local(qg, kr):
    return torch.einsum("bkgh,bsckh->bskgc", qg, kr)


def _pv_local(p, vr):
    return torch.einsum("bskgc,bsckh->bskgh", p, vr)


def _attend_decode_splitk(q, k, v, t, cfg: ModelConfig, ns: int, scale):
    """q (B, 1, nq, hd); k/v (B, S, n_kv, hd) sequence-sharded; t the
    position (a scalar or one per row) -> (B, 1, nq, hd) in q's dtype.

    S is reshaped to (ns, S/ns) so the shard axis is explicit; each
    shard's masked fp32 softmax partials (max, sum, P.V) are local and
    the combine is an O(B nq hd) reduction over ``ns`` (an all-reduce of
    KB under DTensor, not an all-gather of the GB-scale cache).  GQA by
    grouping the query heads."""
    f32 = torch.float32
    b, s, nkv, hd = k.shape
    nq = q.shape[2]
    c = s // ns
    # the query's heads whole (KBs): grouping them by KV head splits the
    # head axis, which a shard of it need not divide
    q = logical_constraint(q, "act_batch", None, None, None)
    kr = logical_constraint(k.reshape(b, ns, c, nkv, hd),
                            "act_batch", "cache_seq", None, None, None)
    vr = logical_constraint(v.reshape(b, ns, c, nkv, hd),
                            "act_batch", "cache_seq", None, None, None)
    ts = torch.as_tensor(t, device=q.device).to(torch.int64).reshape(-1)
    kpos = (torch.arange(ns, device=q.device)[:, None] * c
            + torch.arange(c, device=q.device)[None, :])     # (ns, c)
    valid = kpos[None] <= ts[:, None, None]                 # (B or 1, ns, c)
    qg = q.reshape(b, nkv, nq // nkv, hd).to(f32)
    # the products on batch and sequence shards: DTensor's einsum plans
    # a flatten of a sharded dim for some shapes (torch 2.11)
    scores = on_local_shards(_scores_local, (qg, kr.to(f32)),
                             ((0, None), (0, 1)), ((0, 1),)) * scale
    scores = _softcap(scores, cfg.attn_logit_softcap)
    scores = torch.where(valid[:, :, None, None, :], scores, NEG_INF)
    m_i = scores.amax(dim=-1)                               # (B, ns, nkv, g)
    p = torch.exp(scores - m_i[..., None])
    l_i = p.sum(dim=-1)
    o_i = on_local_shards(_pv_local, (p, vr.to(f32)),
                          ((0, 1), (0, 1)), ((0, 1),))
    # combine over the sharded ns axis (small all-reduces under DTensor)
    m = m_i.amax(dim=1, keepdim=True)
    w = torch.exp(m_i - m)                                  # (B, ns, nkv, g)
    denom = (w * l_i).sum(dim=1)                            # (B, nkv, g)
    num = (w[..., None] * o_i).sum(dim=1)                   # (B, nkv, g, hd)
    out = num / denom.clamp_min(1e-30)[..., None]
    return out.reshape(b, 1, nq, hd).to(q.dtype)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                    window: int = 0, device) -> dict:
    """Dense cache of ``max_len`` slots (``window`` 0) or rolling-buffer
    cache of ``min(window, max_len)``, in the compute dtype — or int8
    with fp32 ``k_scale`` / ``v_scale`` of shape (B, length, n_kv)."""
    length = min(window, max_len) if window else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    quant = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if quant else compute_dtype(cfg)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def cache_axes() -> dict:
    kv = ("act_batch", "cache_seq", "act_kv_heads", None)
    return {"k": kv, "v": kv, "k_scale": kv[:-1], "v_scale": kv[:-1]}


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 values and an fp32 scale per leading index:
    amax / 127 (at least 1e-6 / 127), values rounded half to even and
    clipped to +-127."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp(min=1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequant_kv(q: torch.Tensor, scale: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dt)


def attend_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  cache: dict, t, *, window: int = 0,
                  cross_cache: dict | None = None):
    """One-token decode. x: (B, 1, d); t: the absolute position, a
    scalar or one per row (B,).  Returns (y, new_cache); the cache is
    not written in place.  With ``cross_cache`` (the encoder output's
    precomputed k/v) it attends to every encoder position instead and
    passes ``cache`` through."""
    if cross_cache is not None:
        out = _attend_plain(_project_q(params, x, cfg), cross_cache["k"],
                            cross_cache["v"], cfg)
        return _out(params, out), cache
    b = x.shape[0]
    ts = torch.as_tensor(t, device=x.device).to(torch.int64).reshape(-1) \
        .expand(b)
    q = _project_q(params, x, cfg)                 # (B, 1, nq, hd)
    k_new, v_new = _project_kv(params, x, cfg)
    if cfg.rope_fraction > 0:
        q = apply_rope(q, ts[:, None], cfg)
        k_new = apply_rope(k_new, ts[:, None], cfg)
    length = cache["k"].shape[1]
    ns = _splitk_shards(cfg, length) if not window else 0
    # a dense cache writes at the position itself, clamped into the
    # cache as the reference's dynamic_update_slice clamps it
    slot = ts % length if window else ts.clamp(max=length - 1)
    idx = torch.arange(length, device=x.device)
    quant = cfg.kv_cache_dtype == "int8"
    if quant:
        writes = dict(zip(("k", "k_scale"), _quant_kv(k_new)))
        writes.update(zip(("v", "v_scale"), _quant_kv(v_new)))
    else:
        writes = {"k": k_new, "v": v_new}
    # every cache is written by an elementwise select into a new buffer,
    # local on every shard of a sequence-sharded cache, as the reference
    # writes its sequence-sharded cache
    sel = idx[None, :] == slot[:, None]                     # (B, length)
    new_cache = {}
    for name, val in writes.items():
        buf = cache[name]
        new_cache[name] = torch.where(
            sel.reshape(sel.shape + (1,) * (buf.ndim - 2)),
            val.to(buf.dtype), buf)
    if quant:   # the whole cache back in the compute dtype
        k = _dequant_kv(new_cache["k"], new_cache["k_scale"], x.dtype)
        v = _dequant_kv(new_cache["v"], new_cache["v_scale"], x.dtype)
    else:
        k, v = new_cache["k"], new_cache["v"]
    if ns:
        out = _attend_decode_splitk(q, k, v, ts, cfg, ns,
                                    cfg.head_dim ** -0.5)
        return _out(params, out), new_cache
    if window:
        # slot i holds absolute position p_i = t - ((t - i) mod length)
        kpos = ts[:, None] - torch.remainder(ts[:, None] - idx[None, :],
                                             length)
        valid = (kpos >= 0) & (ts[:, None] - kpos < window)
    else:
        valid = idx[None, :] <= ts[:, None]
    # GQA by grouping the query heads (the reference broadcasts each KV
    # head over its group; the products are the same); probabilities
    # and P.V in fp32, the output rounded once: the plain prefill's
    # rounding points (kernels/swa/ops.swa_attention_plain), so a decode
    # step reproduces the prefill's logits
    out = _attend_plain(q, k, v, cfg, valid)
    return _out(params, out), new_cache

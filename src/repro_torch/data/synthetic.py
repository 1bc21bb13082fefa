"""Deterministic synthetic token pipeline (the reference's
``repro.data.synthetic``, in numpy).

The stream is (a) *deterministic in (seed, step)* — restart/resume
yields bit-identical batches, which the fault-tolerance tests rely on —
and (b) *host-shardable* — a host only generates ``[host_offset :
host_offset + per_host]`` rows, and any (num_hosts, host_id)
decomposition yields the same global batch.  Tokens and labels are the
reference's bit for bit: the same numpy generators in the same order.

Tokens follow a Zipfian-ish distribution (realistic softmax/label
traffic, exercises the padded-vocab masking) with a learnable bigram
structure so short training runs have signal: token[t+1] depends on
token[t] through a fixed random permutation.

The audio and vision frontends are stubs (precomputed embeddings): the
reference draws them with ``jax.random.normal``; the port draws the
same threefry bits through ``repro_torch.utils.prng.normal``, within a
few float32 ulps of the reference's values.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import prng


def _zipf_logits(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    return np.log(1.0 / ranks)


def _tokens_for_rows(cfg: ModelConfig, rows: np.ndarray, seq_len: int,
                     seed: int, step: int) -> np.ndarray:
    """Generate (len(rows), seq_len+1) tokens deterministically per row."""
    v = cfg.vocab_size
    zipf = _zipf_logits(v)
    zipf_p = np.exp(zipf - zipf.max())
    zipf_p /= zipf_p.sum()
    perm = np.random.default_rng(seed ^ 0x5EED).permutation(v)
    out = np.empty((len(rows), seq_len + 1), dtype=np.int32)
    for i, r in enumerate(rows):
        rng = np.random.default_rng(
            (seed * 1_000_003 + step) * 1_000_003 + int(r))
        toks = rng.choice(v, size=seq_len + 1, p=zipf_p)
        # bigram structure: with p=0.5 the next token is perm[prev]
        follow = rng.random(seq_len) < 0.5
        for t in range(seq_len):
            if follow[t]:
                toks[t + 1] = perm[toks[t]]
        out[i] = toks
    return out


@dataclasses.dataclass
class SyntheticStream:
    """Batches of ``global_batch // num_hosts`` rows of ``seq_len``
    tokens (int64 tensors on ``device``, the CPU by default)."""
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    device: Any = "cpu"

    @property
    def per_host(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int) -> dict:
        rows = np.arange(self.host_id * self.per_host,
                         (self.host_id + 1) * self.per_host)
        toks = _tokens_for_rows(self.cfg, rows, self.seq_len, self.seed,
                                step)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        _add_frontend_stubs(batch, self.cfg, self.per_host, self.seed, step)
        return {k: torch.as_tensor(
                    v, dtype=torch.int64 if v.dtype == np.int32 else None,
                    device=self.device) for k, v in batch.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _add_frontend_stubs(batch: dict, cfg: ModelConfig, b: int, seed: int,
                        step: int) -> None:
    """Audio/vision frontends are stubs: precomputed embeddings, the
    reference's keys."""
    if cfg.is_encoder_decoder:
        batch["frames"] = prng.normal(prng.prng_key(seed * 7919 + step),
                                      (b, cfg.encoder_len, cfg.d_model))
    if cfg.family == "vlm" and cfg.num_patches:
        batch["patches"] = prng.normal(
            prng.prng_key(seed * 104729 + step + 1),
            (b, cfg.num_patches, cfg.d_model))


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, *, seed: int = 0,
               step: int = 0, device: Any = "cpu") -> dict:
    """One-shot batch (tests / examples)."""
    return SyntheticStream(cfg, batch, seq_len, seed=seed,
                           device=device).batch_at(step)

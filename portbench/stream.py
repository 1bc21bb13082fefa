"""Training batches from the seed: a frozen copy of the port's
synthetic stream (``repro_torch/data/synthetic.py``, ``_zipf_logits``,
``_tokens_for_rows`` and ``SyntheticStream.batch_at`` for one host).

The reference regenerates the batches the program was fed with this
copy, so a later change to the program's stream cannot move what the
reference computes; a test holds the copy bit for bit to the port's
stream at the cells' shapes.
"""
from __future__ import annotations

import numpy as np


def _zipf_logits(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    return np.log(1.0 / ranks)


def tokens_for_rows(vocab: int, rows: np.ndarray, seq_len: int, seed: int,
                    step: int) -> np.ndarray:
    """(len(rows), seq_len + 1) int32 tokens, one generator a row: Zipf
    draws, then with p = 0.5 each next token replaced by a fixed random
    permutation of the one before it."""
    zipf = _zipf_logits(vocab)
    zipf_p = np.exp(zipf - zipf.max())
    zipf_p /= zipf_p.sum()
    perm = np.random.default_rng(seed ^ 0x5EED).permutation(vocab)
    out = np.empty((len(rows), seq_len + 1), dtype=np.int32)
    for i, r in enumerate(rows):
        rng = np.random.default_rng(
            (seed * 1_000_003 + step) * 1_000_003 + int(r))
        toks = rng.choice(vocab, size=seq_len + 1, p=zipf_p)
        follow = rng.random(seq_len) < 0.5
        for t in range(seq_len):
            if follow[t]:
                toks[t + 1] = perm[toks[t]]
        out[i] = toks
    return out


def batch_at(vocab: int, batch: int, seq_len: int, seed: int, step: int
             ) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels), each (batch, seq_len) int64: step ``step`` of
    the stream of ``seed``."""
    toks = tokens_for_rows(vocab, np.arange(batch), seq_len, seed, step)
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)

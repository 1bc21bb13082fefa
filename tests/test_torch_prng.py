"""The port's numpy threefry2x32 (``repro_torch.utils.prng``) against
``jax.random`` on the CPU.

Keys, random bits and uniforms are held exactly over many (seed, rid,
n) keys and a vocabulary-sized shape.  The port rounds each ``log``
once from float64, and XLA's float32 ``log`` may differ from that by an
ulp: each of the Gumbel's two logs is held to one ulp of XLA's on the
same input, and so the Gumbel values to two ulps of max(|g|, 1).  The
sampled tokens are held equal over thousands of draws, the way the
serving engine draws them (``fold_in(fold_in(PRNGKey(seed), rid), n)``,
logits divided by the temperature in float32)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.utils import prng  # noqa: E402

SEEDS = (0, 1, 3, 12345, 2**31 - 1, -1, -7)
TINY = np.finfo(np.float32).tiny


def _keys(seed):
    """(rid, n) keys of one seed: the engine's fold-in order."""
    jk, k = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for rid in (0, 1, 7, 99, 4096):
        for n in (0, 1, 31, 1000):
            yield (jax.random.fold_in(jax.random.fold_in(jk, rid), n),
                   prng.fold_in(prng.fold_in(k, rid), n))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax_exactly(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          prng.prng_key(seed))
    for jk, k in _keys(seed):
        assert k.dtype == np.uint32
        assert np.array_equal(np.asarray(jk), k)


@pytest.mark.parametrize("shape", [(1,), (7,), (50_280,), (3, 5)])
def test_bits_and_uniforms_match_jax_exactly(shape):
    for seed in (0, 3):
        for jk, k in list(_keys(seed))[::5]:
            assert np.array_equal(
                np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
                prng.random_bits(k, shape))
            for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
                want = np.asarray(jax.random.uniform(jk, shape, jnp.float32,
                                                     lo, hi))
                got = prng.uniform(k, shape, lo, hi)
                assert got.dtype == np.float32
                assert np.array_equal(got, want)


def _ulps(got, want):
    """|got - want| in float32 ulps of max(|want|, 1)."""
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    return np.abs(got.astype(np.float64) - want) / ulp


def test_gumbel_within_an_ulp_a_log_of_jax():
    """Each of the Gumbel's two float32 logs is within one ulp of XLA's
    on the same input, and the Gumbel values within two ulps of
    max(|g|, 1) end to end: one from each log (the inner log's ulp
    reaches the output divided by |log u|, under one ulp)."""
    worst = {"inner": 0.0, "outer": 0.0, "gumbel": 0.0}
    differ = total = 0
    for seed in (0, 3):
        for jk, k in _keys(seed):
            u = prng.uniform(k, (50_280,), TINY, 1.0)
            inner = prng._log32(u)
            j_inner = np.asarray(jnp.log(jnp.asarray(u)))
            outer = prng._log32(-j_inner)
            j_outer = np.asarray(jnp.log(jnp.asarray(-j_inner)))
            want = np.asarray(jax.random.gumbel(jk, (50_280,), jnp.float32))
            got = prng.gumbel(k, (50_280,))
            assert got.dtype == np.float32
            assert np.array_equal(-j_outer, want)   # JAX's own Gumbel
            for name, a, b in (("inner", inner, j_inner),
                               ("outer", outer, j_outer),
                               ("gumbel", got, want)):
                err = _ulps(a, b) if name == "gumbel" else \
                    np.abs(a.astype(np.float64) - b) / np.spacing(b)
                worst[name] = max(worst[name], float(err.max()))
            differ += int((got != want).sum())
            total += got.size
    assert worst["inner"] <= 1.0 and worst["outer"] <= 1.0, worst
    assert worst["gumbel"] <= 2.0, worst
    assert differ < total // 2      # most values are bit-equal


@pytest.mark.parametrize("vocab,scale,draws", [(256, 1.0, 4000),
                                               (50_280, 3.0, 600)])
def test_sampled_tokens_match_jax(vocab, scale, draws):
    """The engine's draw at temperature 0.8: ``draws`` (seed, rid, n)
    keys over fresh logits each, sampled by both, all equal; where one
    differed, it would have to be a tie of ``logits + gumbel`` within
    the ulp the Gumbel values may differ by."""
    rng = np.random.default_rng(vocab)
    temp = 0.8
    cases = [(int(rng.integers(0, 8)), int(rng.integers(0, 64)),
              int(rng.integers(0, 64))) for _ in range(draws)]
    logits = (scale * rng.standard_normal((draws, vocab))).astype(np.float32)
    scaled = logits / np.float32(temp)

    def jkey(seed, rid, n):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
        return jax.random.fold_in(k, n)

    keys = jnp.stack([jkey(*c) for c in cases])
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(scaled)))
    got = np.array([prng.categorical(
        prng.fold_in(prng.fold_in(prng.prng_key(s), r), n), row)
        for (s, r, n), row in zip(cases, scaled)])
    bad = np.flatnonzero(got != want)
    for i in bad:
        s, r, n = cases[i]
        z = prng.gumbel(prng.fold_in(prng.fold_in(prng.prng_key(s), r), n),
                        (vocab,)) + scaled[i]
        gap = abs(float(z[got[i]]) - float(z[want[i]]))
        assert gap <= 2 * np.spacing(np.float32(abs(z).max())), \
            f"draw {i}: tokens {got[i]} / {want[i]} are no near tie ({gap})"
    assert len(bad) == 0, f"near ties at draws {bad.tolist()}"
    assert len(set(got.tolist())) > min(vocab, draws) // 4

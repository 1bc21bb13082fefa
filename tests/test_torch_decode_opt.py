"""Split-K decode and the perf presets against the reference: twins of
tests/test_decode_opt.py's split-K math and preset tests, and the port's
``attend_decode`` under a sequence-sharded cache rule against its own
dense decode."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import presets as j_presets  # noqa: E402
from repro.models.attention import (  # noqa: E402
    _attend_decode_splitk as j_splitk,
)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.presets import PERF_PRESETS, preset_for  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    _attend_decode_splitk,
    _splitk_shards,
    attend_decode,
)
from repro_torch.sharding import activate_rules  # noqa: E402


@pytest.mark.parametrize("ns", [2, 4, 8])
def test_splitk_math_matches_reference(ns):
    """Per-shard partial softmax + combine, the same numpy inputs through
    both packages' split-K (grok's softcap, fp32)."""
    jcfg = j_smoke("grok-1-314b")
    cfg = get_smoke_config("grok-1-314b")
    assert cfg.attn_logit_softcap == jcfg.attn_logit_softcap > 0
    rng = np.random.default_rng(0)
    b, s, nq, hd = 2, 64, 4, 16
    q = rng.standard_normal((b, 1, nq, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nq, hd)).astype(np.float32)
    t, scale = 40, hd ** -0.5        # positions > t must be masked
    want = j_splitk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.int32(t), jcfg, ns, scale)
    got = _attend_decode_splitk(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), t, cfg, ns, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_splitk_shards_follow_the_cache_rule():
    cfg = get_smoke_config("grok-1-314b")
    mesh = make_mesh((1, 4), ("data", "model"))
    assert _splitk_shards(cfg, 64) == 0                  # no rules
    with activate_rules(mesh):
        assert _splitk_shards(cfg, 64) == 0              # cache_seq -> ()
    with activate_rules(mesh, {"cache_seq": ("model",)}):
        assert _splitk_shards(cfg, 64) == 4
        assert _splitk_shards(cfg, 66) == 0              # 66 % 4: dense


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_attend_decode_splitk_matches_dense(kv_dtype):
    """The port's decode step with ``cache_seq -> model`` over 4 shards
    (select-write, split-K) against its dense decode, fp32, rows at
    their own positions."""
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"),
                              dtype="float32", kv_cache_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(0)
    params = {k: p.value for k, p in
              attn.init_attention(gen, cfg, torch.device("cpu")).items()}
    b, length = 3, 64
    cache = attn.init_attn_cache(cfg, b, length, device="cpu")
    rng = np.random.default_rng(1)
    for name in ("k", "v"):
        if kv_dtype == "int8":
            cache[name] = torch.from_numpy(rng.integers(
                -127, 128, cache[name].shape).astype(np.int8))
            cache[name + "_scale"] = torch.from_numpy(rng.uniform(
                0.001, 0.02, cache[name + "_scale"].shape)
                .astype(np.float32))
        else:
            cache[name] = torch.from_numpy(rng.standard_normal(
                cache[name].shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model))
                         .astype(np.float32))
    ts = torch.tensor([5, 40, 63])
    want, want_cache = attend_decode(params, x, cfg, cache, ts)
    calls = []

    def spy(*args):
        calls.append(args[5])
        return _attend_decode_splitk(*args)

    mesh = make_mesh((1, 4), ("data", "model"))
    with activate_rules(mesh, {"cache_seq": ("model",)}), \
            pytest.MonkeyPatch.context() as m:
        m.setattr(attn, "_attend_decode_splitk", spy)
        got, got_cache = attend_decode(params, x, cfg, cache, ts)
    assert calls == [4]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    for name in want_cache:
        assert torch.equal(got_cache[name], want_cache[name]), name


def test_perf_presets_importable():
    assert preset_for("qwen2-0.5b", "train_4k") is not None
    assert preset_for("qwen2-0.5b", "decode_32k") is None
    for (arch, shape), p in PERF_PRESETS.items():
        assert set(p) <= {"overrides", "rule_overrides", "microbatches"}
    assert PERF_PRESETS == j_presets.PERF_PRESETS

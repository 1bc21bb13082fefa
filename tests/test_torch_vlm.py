"""The port's VLM input stage (internvl2-26b; smoke config) against the
reference.

A batch's ``"patches"`` (B, P, d), precomputed patch embeddings, run as
the first P positions: cast to the compute dtype and put before the
token embeddings; ``forward``'s logits leave them out and ``prefill``'s
``t_next`` counts them.  The reference's weights are carried across with
``repro_torch.convert.model_tree`` and both packages get the same
numpy-made tokens and patches.  The forward, prefill caches and decode
steps hold the reference's at 1e-4 in fp32 and, in bf16, at rtol 2e-2 /
atol 0.08 (the port's other bf16 model tests' floor,
tests/test_torch_dense.py::test_bf16_gap_is_three_rounding_points says
why); the port's own decode holds its forward at
tests/test_decode_parity.py's tolerance for this arch (2e-2 one step,
7e-2 over four).  The serving engine, whose slots start decoding at the
prompt's token count as the reference's do (ROADMAP, port faults), gives
the reference engine's tokens, step log, oracle cycles and stats."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as j_models  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.kernels.swa import kernel as t_swa_kernel  # noqa: E402
from repro_torch.kernels.swa import ops as t_swa_ops  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.types import param_values  # noqa: E402

ARCH = "internvl2-26b"
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=0.08)}
# tests/test_decode_parity.py's tolerances for internvl2-26b
ATOL_SINGLE, ATOL_MULTI = 2e-2, 7e-2
BATCH, SEQ, CACHE = 2, 24, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype):
    return (dataclasses.replace(j_smoke(ARCH), dtype=dtype),
            dataclasses.replace(t_smoke(ARCH), dtype=dtype))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _patches(cfg, b, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks, patches):
    return ({"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)},
            {"tokens": torch.as_tensor(toks),
             "patches": torch.from_numpy(patches)})


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
def test_configs_and_working_sets_match_reference():
    assert ARCH in ARCHS
    for jcfg, tcfg in ((j_get(ARCH), get_config(ARCH)),
                       (j_smoke(ARCH), t_smoke(ARCH))):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert dataclasses.asdict(j_models.decode_working_set(jcfg)) == \
            dataclasses.asdict(t_models.decode_working_set(tcfg))
        assert tcfg.param_count() == jcfg.param_count()
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.num_patches, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim) == ("vlm", 256, 48, 8, 128)
    # the depth cut the card runs: 24 of 48 layers, 42.0 GB of fp32
    cut = dataclasses.replace(cfg, num_layers=24)
    assert dataclasses.replace(j_get(ARCH), num_layers=24).param_count() \
        == cut.param_count() == 10_499_272_704
    assert cfg.param_count() == 19_861_254_144


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
def test_forward_with_patches_matches_reference(pair, monkeypatch):
    """The patch prefix runs through every layer (one swa call each, the
    band as wide as P + S) and the logits cover the S tokens only."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    jb, tb = _batches(jcfg, toks, _patches(jcfg, BATCH))
    windows = []

    def counting(q, k, v, **kw):
        windows.append(kw["window"])
        return t_swa_ops.swa_attention_plain(q, k, v, **kw)

    monkeypatch.setattr(t_swa_ops, "swa_attention", counting)
    want = j_models.forward(jp, jb, jcfg, mode="prefill")
    got = t_models.forward(tp, tb, tcfg)
    assert windows == [SEQ + jcfg.num_patches] * jcfg.num_layers
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (BATCH, SEQ, want.shape[-1])
    _close(got, want, MODEL_TOL[dtype])


def test_forward_without_patches_runs_as_text(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ), seed=4)
    want = j_models.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill")
    got = t_models.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    _close(got, want, MODEL_TOL[dtype])
    jb, tb = _batches(jcfg, toks, _patches(jcfg, BATCH))
    with_patches = t_models.forward(tp, tb, tcfg)
    assert float((with_patches - got).abs().max()) > 1e-3


def test_prefill_logits_and_caches_match_reference(pair):
    """``t_next`` counts the patches; the dense cache holds the patch
    positions, then the tokens', then empty slots."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    jb, tb = _batches(jcfg, toks, _patches(jcfg, BATCH))
    jl, jc, jt = j_models.prefill(jp, jb, jcfg, CACHE)
    tl, tc, tt = t_models.prefill(tp, tb, tcfg, CACHE)
    n = SEQ + jcfg.num_patches
    assert tt == int(jt) == n
    _close(tl, jl, MODEL_TOL[dtype])
    jleaves, jdef = jax.tree.flatten(jc)
    tleaves, tdef = jax.tree.flatten(
        tc, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert tdef == jdef
    for got, want in zip(tleaves, jleaves):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want, MODEL_TOL[dtype])
    k = tc["blocks"][0]["k"]
    assert not bool(k[:, :, n:].any()) and bool(k[:, :, n - 1].any())


def test_decode_steps_match_reference(pair):
    """Four steps from the reference's own prefill caches (patches and
    20 tokens), carried across: ``decode_step`` in both packages, at the
    positions past the patch prefix."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    jb, _ = _batches(jcfg, toks[:, :-4], _patches(jcfg, BATCH))
    _, jc, jt = j_models.prefill(jp, jb, jcfg, CACHE)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


def test_decode_matches_forward():
    """tests/test_decode_parity.py's check on the port (bf16, the smoke
    config, seeded patches): prefill the patches and S - 1 tokens,
    decode the last, against the forward's last position; then four
    steps carried across from 28 tokens."""
    cfg = t_smoke(ARCH)
    params = param_values(t_models.init_params(0, cfg, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg, (BATCH, 32), seed=2))
    patches = torch.from_numpy(_patches(cfg, BATCH, seed=3))
    full = t_models.forward(params, {"tokens": toks, "patches": patches},
                            cfg)
    _, caches, t = t_models.prefill(
        params, {"tokens": toks[:, :-1], "patches": patches}, cfg, 48)
    assert t == 31 + cfg.num_patches
    got, _ = t_models.decode_step(params, caches, toks[:, -1:], t, cfg)
    _close(got, full[:, -1], dict(rtol=2e-2, atol=ATOL_SINGLE))
    _, caches, t = t_models.prefill(
        params, {"tokens": toks[:, :28], "patches": patches}, cfg, 48)
    for i in range(4):
        got, caches = t_models.decode_step(params, caches,
                                           toks[:, 28 + i:29 + i], t + i, cfg)
        _close(got, full[:, 28 + i], dict(rtol=7e-2, atol=ATOL_MULTI))


def test_slot_decode_matches_reference(pair):
    """Rows prefilled with their own patches to 9 and 20 tokens decode
    four steps each at their own positions."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, 28))
    patches = _patches(jcfg, BATCH, seed=11)
    lens = (9, 20)
    rows = [j_models.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n]),
                                  "patches": jnp.asarray(patches[r:r + 1])},
                             jcfg, CACHE)[1] for r, n in enumerate(lens)]
    axes = j_models.cache_slot_axes(rows[0])
    jc = jax.tree.map(lambda ax, *xs: jnp.concatenate(xs, axis=ax), axes,
                      *rows)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    p = jcfg.num_patches
    for i in range(4):
        ts = np.array([p + n + i for n in lens], np.int32)
        tok = np.stack([toks[r, n + i] for r, n in enumerate(lens)])[:, None]
        jl, jc = j_models.slot_decode_step(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(ts), jcfg)
        tl, tc = t_models.slot_decode_step(tp, tc, torch.as_tensor(tok),
                                           torch.as_tensor(ts), tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _engines(dtype, **kw):
    jcfg, tcfg = _configs(dtype)
    jparams = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(7):
        plen = (24, 11, 30)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        extras = {"patches": _patches(tcfg, 1, seed=100 + i)[0]}
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6), extras=extras)
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6), extras=extras)
    return jeng, teng


def test_engine_matches_reference_engine_fp32():
    """fp32, temperature 0, each request with its own seeded patches,
    more requests than slots: the tokens, step log (oracle cycles
    included) and stats are the reference engine's.  Both engines start
    a slot's decode at its prompt's token count, without the patches."""
    jeng, teng = _engines("float32", cache_len=56, max_slots=3, eos_id=-1,
                          temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    assert {r.kind for r in teng.step_log} >= {"prefill", "decode",
                                               "mixed"}


def test_engine_stats_and_cycles_match_reference_bf16():
    jeng, teng = _engines("bfloat16", cache_len=56, max_slots=3, eos_id=-1,
                          temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    keep = ("step", "kind", "cycles", "sim_time_s", "active", "admitted",
            "finished", "llc_hit_rate")
    assert [{k: r.to_record()[k] for k in keep} for r in teng.step_log] == \
        [{k: r.to_record()[k] for k in keep} for r in jeng.step_log]


def test_serve_cli_runs_internvl2_on_cpu(capsys):
    from repro_torch.serve.__main__ import main as serve_main

    serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--prompt-len", "12", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke  device=cpu" in out
    assert "simulated SoC:" in out


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------
@pytest.mark.gpu
def test_prefill_through_kernel_matches_plain_on_card(monkeypatch):
    """bf16 prefill of patches and tokens on the card: attention through
    the Hopper kernel (one launch per layer, the band as wide as P + S)
    against the same prefill through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = t_smoke(ARCH)
    params = param_values(t_models.init_params(0, cfg, device=dev))
    batch = {"tokens": torch.as_tensor(_tokens(cfg, (3, 137)), device=dev),
             "patches": torch.from_numpy(_patches(cfg, 3)).to(dev)}
    before = t_swa_kernel.launches
    got, _, t = t_models.prefill(params, batch, cfg, 160)
    assert t == 137 + cfg.num_patches
    assert t_swa_kernel.launches == before + cfg.num_layers
    monkeypatch.setattr(t_swa_ops, "swa_attention",
                        t_swa_ops.swa_attention_plain)
    want, _, _ = t_models.prefill(params, batch, cfg, 160)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), MODEL_TOL["bfloat16"])

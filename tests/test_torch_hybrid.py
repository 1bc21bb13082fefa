"""The port's Griffin hybrid (recurrentgemma-9b, smoke config) against
the reference.

Every function of the slice — RoPE, the gated GeGLU MLP, the scaled
embedding, the RG-LRU block and its decode step, local attention with
its rolling-buffer decode, and the model's forward, prefill caches,
``decode_step`` and ``slot_decode_step`` — gets the same numpy-made
inputs and the reference's weights (``repro_torch.convert.model_tree``)
in both packages.  fp32 holds at rtol = atol = 1e-4 (the RG-LRU scan
sums in another order than ``associative_scan``).  In bf16 each block
holds at rtol = atol = 2e-2 (the reference's one-step decode-parity
tolerance for this arch, tests/test_decode_parity.py); the whole model,
four bf16 blocks deep, at the wider absolute floor the port's mamba-2
tests use for one step (atol 0.08), since the two frameworks round bf16
at different points (the logits differ by up to 0.07 at this size,
where fp32 agrees to 4e-6).  The smoke config's window is 16, so a
24-token prompt runs attention past the window and decode wraps the
rolling buffer."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as j_models  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.kernels.swa import kernel as t_swa_kernel  # noqa: E402
from repro_torch.kernels.swa import ops as t_swa_ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.types import param_values  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = {"float32": TOL["float32"],
             "bfloat16": dict(rtol=2e-2, atol=0.08)}
BATCH, SEQ, CACHE = 2, 24, 40       # SEQ > the smoke window of 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype=request.param)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype=request.param)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _act(jcfg, shape, seed):
    """Activations rounded to the compute dtype once, in both packages."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(t_layers.compute_dtype(jcfg))
    return jnp.asarray(_np(t)).astype(j_layers.compute_dtype(jcfg)), t


def _tokens(jcfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, jcfg.vocab_size, shape)


def _attn_block(jp, tp):
    """The first attention layer's parameters (pattern position 2 of
    the first group) in both packages."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"][2]["attn"]),
            t_models.transformer.layer(tp["blocks"][2]["attn"], 0))


def _rec_block(jp, tp):
    return jp["rem"][0]["rec"], tp["rem"][0]["rec"]


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def test_rope_mlp_and_embedding_match_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    assert t_layers.rope_dim(tcfg) == j_layers.rope_dim(jcfg) == 8
    jx, tx = _act(jcfg, (BATCH, SEQ, jcfg.num_heads, jcfg.head_dim), 2)
    pos = np.arange(3, 3 + SEQ)
    _close(t_layers.apply_rope(tx, torch.as_tensor(pos), tcfg),
           j_layers.apply_rope(jx, jnp.asarray(pos), jcfg), TOL[dtype])
    jh, th = _act(jcfg, (BATCH, SEQ, jcfg.d_model), 3)
    jm = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mlp"])
    tm = t_models.transformer.layer(tp["blocks"][0]["mlp"], 0)
    _close(t_layers.apply_mlp(tm, th, tcfg),
           j_layers.apply_mlp(jm, jh, jcfg), TOL[dtype])
    toks = _tokens(jcfg, (BATCH, SEQ))
    got = t_layers.embed_tokens(tp["embed"], torch.as_tensor(toks), tcfg)
    want = j_layers.embed_tokens(jp["embed"], jnp.asarray(toks), jcfg)
    assert got.dtype == t_layers.compute_dtype(tcfg)
    # the sqrt(d_model) scale in the compute dtype: equal bit for bit
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    got = t_layers._act("gelu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------
def test_linear_scan_matches_a_sequential_loop():
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, n, 3))
                             .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, n, 3))
                             .astype(np.float32))
        h, want = torch.zeros(2, 3), []
        for t in range(n):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(t_rglru.linear_scan(a, b), torch.stack(want, 1),
               dict(rtol=1e-5, atol=1e-6))


def test_rglru_block_and_decode_match_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    jr, tr = _rec_block(jp, tp)
    jx, tx = _act(jcfg, (BATCH, SEQ, jcfg.d_model), 5)
    want, jcache = j_rglru.apply_rglru(jr, jx, jcfg, return_state=True)
    got, tcache = t_rglru.apply_rglru(tr, tx, tcfg, return_state=True)
    _close(got, want, TOL[dtype])
    assert tcache["conv"].dtype == torch.bfloat16
    assert tcache["h"].dtype == torch.float32
    _close(tcache["h"], jcache["h"], TOL[dtype])
    _close(tcache["conv"], jcache["conv"], TOL[dtype])
    ju, tu = _act(jcfg, (BATCH, SEQ, jcfg.rglru_width), 6)
    _close(t_rglru.rglru_scan(tr, tu), j_rglru.rglru_scan(jr, ju), TOL[dtype])
    # three decode steps from the reference's own cache, carried across
    tcache = model_tree(jax.tree.map(np.asarray, jcache), device="cpu")
    for i in range(3):
        jx1, tx1 = _act(jcfg, (BATCH, 1, jcfg.d_model), 7 + i)
        want, jcache = j_rglru.apply_rglru_decode(jr, jx1, jcfg, jcache)
        got, tcache = t_rglru.apply_rglru_decode(tr, tx1, tcfg, tcache)
        _close(got, want, TOL[dtype])
        _close(tcache["h"], jcache["h"], TOL[dtype])
        _close(tcache["conv"], jcache["conv"], TOL[dtype])


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def test_attend_past_the_window_matches_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    ja, ta = _attn_block(jp, tp)
    jx, tx = _act(jcfg, (BATCH, SEQ, jcfg.d_model), 8)
    pos = np.arange(SEQ)
    want, (jk, jv) = j_attn.attend(ja, jx, jcfg, positions=jnp.asarray(pos),
                                   window=jcfg.local_window, return_kv=True)
    got, (tk, tv) = t_attn.attend(ta, tx, tcfg, positions=torch.as_tensor(pos),
                                  window=tcfg.local_window, return_kv=True)
    _close(got, want, TOL[dtype])
    _close(tk, jk, TOL[dtype])
    _close(tv, jv, TOL[dtype])


def test_attend_decode_wraps_the_rolling_buffer(pair):
    """Six steps from a 14-token prompt with a window of 16: positions
    14..19 write slots 14, 15, 0, 1, 2, 3; the rows of one step sit at
    different positions (t and t + 3)."""
    dtype, jcfg, tcfg, jp, tp = pair
    ja, ta = _attn_block(jp, tp)
    w = jcfg.local_window
    jc = j_attn.init_attn_cache(jcfg, 1, CACHE, window=w)
    jx, _ = _act(jcfg, (1, 20, jcfg.d_model), 9)
    # fill the buffer through the reference's own decode, one row
    for t in range(14):
        _, jc = j_attn.attend_decode(ja, jx[:, t:t + 1], jcfg, jc,
                                     jnp.asarray(t, jnp.int32), window=w)
    # two rows: the same history, advanced 0 and 3 more steps
    jc2 = jc
    for t in range(14, 17):
        _, jc2 = j_attn.attend_decode(ja, jx[:, t:t + 1], jcfg, jc2,
                                      jnp.asarray(t, jnp.int32), window=w)
    cache = {k: jnp.concatenate([jc[k], jc2[k]]) for k in ("k", "v")}
    tcache = model_tree(jax.tree.map(np.asarray, cache), device="cpu")
    jcs = [jc, jc2]
    for step in range(6):
        ts = np.array([14 + step, 17 + step], np.int32)
        jx1, tx1 = _act(jcfg, (2, 1, jcfg.d_model), 20 + step)
        wants = []
        for r in range(2):
            y, jcs[r] = j_attn.attend_decode(
                ja, jx1[r:r + 1], jcfg, jcs[r],
                jnp.asarray(ts[r], jnp.int32), window=w)
            wants.append(y)
        got, tcache = t_attn.attend_decode(ta, tx1, tcfg, tcache,
                                           torch.as_tensor(ts), window=w)
        _close(got, jnp.concatenate(wants), TOL[dtype])
        for k in ("k", "v"):
            _close(tcache[k], jnp.concatenate([c[k] for c in jcs]),
                   TOL[dtype])


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
def test_forward_matches_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    want = j_models.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill")
    got = t_models.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, MODEL_TOL[dtype])


def test_prefill_logits_and_caches_match_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    jl, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  CACHE)
    tl, tc, tt = t_models.prefill(tp, {"tokens": torch.as_tensor(toks)},
                                  tcfg, CACHE)
    assert tt == int(jt) == SEQ
    _close(tl, jl, MODEL_TOL[dtype])
    jleaves, jdef = jax.tree.flatten(jc)
    tleaves, tdef = jax.tree.flatten(
        tc, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert tdef == jdef
    for got, want in zip(tleaves, jleaves):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want, MODEL_TOL[dtype])
    # the attention caches are rolling buffers of the window's length,
    # holding the last 16 positions at position mod 16
    assert tuple(tc["blocks"][2]["k"].shape) == \
        (1, BATCH, jcfg.local_window, 1, jcfg.head_dim)


def test_decode_steps_match_reference(pair):
    """Four steps from the reference's own prefill caches, carried
    across, past the window: ``decode_step`` in both packages."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    pre = toks[:, :SEQ - 4]
    _, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(pre)}, jcfg,
                                 CACHE)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


def _row_caches(jp, jcfg, toks, lens):
    """The reference's prefill of each row at its own length, joined on
    the slot axis (1 for stacked ``blocks``, 0 for ``rem``)."""
    rows = [j_models.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n])},
                             jcfg, CACHE)[1] for r, n in enumerate(lens)]
    axes = j_models.cache_slot_axes(rows[0])
    return jax.tree.map(lambda ax, *xs: jnp.concatenate(xs, axis=ax),
                        axes, *rows)


def test_slot_decode_with_a_position_per_row_matches_reference(pair):
    """Rows at positions 13 and 22 (one inside the window, one past
    it): RoPE, the write slot and the valid mask take each row's own
    position."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ + 4))
    lens = (13, 22)
    jc = _row_caches(jp, jcfg, toks, lens)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(3):
        ts = np.array([n + i for n in lens], np.int32)
        tok = np.stack([toks[r, n + i] for r, n in enumerate(lens)])[:, None]
        jl, jc = j_models.slot_decode_step(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(ts), jcfg)
        tl, tc = t_models.slot_decode_step(tp, tc, torch.as_tensor(tok),
                                           torch.as_tensor(ts), tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


def test_configs_match_reference():
    from repro.configs import get_config as j_get
    from repro_torch.configs import get_config as t_get

    for jcfg, tcfg in ((j_get(ARCH), t_get(ARCH)),
                       (j_smoke(ARCH), t_smoke(ARCH))):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    cfg = t_get(ARCH)
    assert cfg.layer_kinds().count("rec") == 26
    assert cfg.layer_kinds().count("attn") == 12
    assert t_models.pattern_split(cfg) == (("rec", "rec", "attn"), 12, 2)


def test_unported_options_raise():
    """A block kind the reference does not have still raises and names
    the ones it has.  The options once refused here run as the
    reference's on the hybrid: an int8 KV cache in its local-attention
    layers (rolling buffers of int8 values and scales; a prefill past
    the window and three decode steps in fp32, at
    tests/test_torch_int8kv.py's 1e-3) and the VLM input stage."""
    with pytest.raises(NotImplementedError, match="block kinds"):
        t_models.init_params(0, dataclasses.replace(
            t_smoke(ARCH), block_pattern=("rec", "mlp")), device="cpu")
    toks = _tokens(t_smoke(ARCH), (BATCH, SEQ))
    tol = dict(rtol=1e-3, atol=1e-3)
    for kw in (dict(kv_cache_dtype="int8"), dict(family="vlm",
                                                  num_patches=4)):
        jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32", **kw)
        tcfg = dataclasses.replace(t_smoke(ARCH), dtype="float32", **kw)
        jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
        tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(
            toks)}
        if tcfg.family == "vlm":
            patches = np.random.default_rng(8).standard_normal(
                (BATCH, 4, tcfg.d_model)).astype(np.float32)
            jb["patches"] = jnp.asarray(patches)
            tb["patches"] = torch.from_numpy(patches)
            _close(t_models.forward(tp, tb, tcfg),
                   j_models.forward(jp, jb, jcfg, mode="prefill"), tol)
        jl, jc, jt = j_models.prefill(jp, jb, jcfg, CACHE)
        tl, tc, tt = t_models.prefill(tp, tb, tcfg, CACHE)
        assert tt == int(jt)
        _close(tl, jl, tol)
        tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
        for i in range(3):
            tok = toks[:, i:i + 1]
            jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                          jnp.asarray(int(jt) + i,
                                                      jnp.int32), jcfg)
            tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok),
                                          tt + i, tcfg)
            _close(tl, jl, tol)


def test_params_and_caches_keep_the_reference_layout():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = param_values(t_models.init_params(0, tcfg, device="cpu"))
    assert jax.tree.map(lambda a: a.shape, jparams) == jax.tree.map(
        lambda a: tuple(a.shape), tparams,
        is_leaf=lambda a: isinstance(a, torch.Tensor))
    jcache = j_values(j_models.init_caches(jcfg, 3, CACHE))
    tcache = param_values(t_models.init_caches(tcfg, 3, CACHE, device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                     tcache, is_leaf=lambda a: isinstance(a, torch.Tensor))


@pytest.mark.gpu
def test_prefill_through_kernel_matches_plain_on_card(monkeypatch):
    """bf16 prefill on the card past the window: attention through the
    Hopper kernel (one launch per attention layer) against the same
    prefill through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    tcfg = t_smoke(ARCH)
    params = param_values(t_models.init_params(0, tcfg, device=dev))
    toks = torch.as_tensor(_tokens(tcfg, (3, 37)), device=dev)
    before = t_swa_kernel.launches
    got, _, _ = t_models.prefill(params, {"tokens": toks}, tcfg, 48)
    n_attn = tcfg.layer_kinds().count("attn")
    assert t_swa_kernel.launches == before + n_attn
    monkeypatch.setattr(t_swa_ops, "swa_attention",
                        t_swa_ops.swa_attention_plain)
    want, _, _ = t_models.prefill(params, {"tokens": toks}, tcfg, 48)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), TOL["bfloat16"])

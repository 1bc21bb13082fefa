"""The port's int8 KV caches (``kv_cache_dtype="int8"``) against the
reference.

``attention._quant_kv`` gives the reference's int8 values and fp32
scales exactly on identical inputs (amax / 127 per K/V vector, round
half to even, clipped to +-127), ties and empty vectors included.
Across the frameworks the K after RoPE differs by an ulp, so a value
can sit on the other side of a rounding boundary: in fp32 the
model-level caches are held to one quantum and the logits and states at
1e-3 (not the fp32 models' 1e-4, since a quantum moves what follows it),
in bf16 at the port's bf16 model floor.  The cache layout (int8 values, ``k_scale`` /
``v_scale`` without the head dim, the same slot axes), the prefill
caches, decode steps, the slot-batched decode and the serving engine
with its oracle (whose KV stream counts the scales) follow the
reference's.  The twin of tests/test_decode_opt.py's
``test_int8_kv_cache_decode_parity`` holds the int8 decode within rel
0.08 of the bf16 forward on deepseek-7b and grok-1-314b, as the
reference's does on the same weights and tokens."""
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
from repro.models import decoding as j_decoding  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import decoding as t_decoding  # noqa: E402
from repro_torch.types import param_values  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCHS = ("deepseek-7b", "grok-1-314b", "mixtral-8x7b", "recurrentgemma-9b",
         "whisper-tiny")
# fp32: the reference's 1e-4 widened to 1e-3, because a K/V value that
# the frameworks' one-ulp difference puts across a rounding boundary
# moves by a quantum (1/127 of its vector's absolute maximum) and every
# later layer and state with it; bf16: the port's bf16 model floor
MODEL_TOL = {"float32": dict(rtol=1e-3, atol=1e-3),
             "bfloat16": dict(rtol=2e-2, atol=0.08)}
BATCH, SEQ, CACHE = 2, 24, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, dtype="bfloat16", **kw):
    kw = dict(kv_cache_dtype="int8", dtype=dtype, **kw)
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def _params(jcfg):
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    return jp, model_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _frames(cfg, b):
    if not cfg.is_encoder_decoder:
        return {}, {}
    fr = np.random.default_rng(5).standard_normal(
        (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return {"frames": jnp.asarray(fr)}, {"frames": torch.from_numpy(fr)}


def _leaves(tree):
    return jax.tree.flatten(tree, is_leaf=lambda a: isinstance(
        a, torch.Tensor))


def _caches_close(tc, jc, dtype):
    """Cache trees alike.  int8 values: in fp32 within one quantum (most
    equal); in bf16, where the two frameworks' K/V already differ by
    bf16 ulps, dequantised with their own scales at the model tolerance.
    Other leaves at the model tolerance, or within one bf16 ulp where an
    fp32 model stores them in bf16 (the conv tails)."""
    tl, tdef = _leaves(tc)
    jl, jdef = jax.tree.flatten(jc)
    assert tdef == jdef
    scales = [(g, np.asarray(w)) for g, w in zip(tl, jl)]
    for i, (got, want) in enumerate(zip(tl, jl)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert tuple(got.shape) == want.shape
        if got.dtype == torch.int8:
            q_t = got.numpy().astype(np.int32)
            q_j = np.asarray(want).astype(np.int32)
            if dtype == "float32":
                diff = np.abs(q_t - q_j)
                assert diff.max() <= 1
                assert (diff > 0).mean() < 0.05
            else:      # the leaf after it in key order is its scale
                s_t, s_j = scales[i + 1]
                _close(q_t * _np(s_t)[..., None], q_j * s_j[..., None],
                       MODEL_TOL[dtype])
        elif got.dtype == torch.bfloat16 and dtype == "float32":
            _close(got, want, dict(rtol=2 ** -7, atol=1e-6))
        else:
            _close(got, want, MODEL_TOL[dtype])


# --------------------------------------------------------------------------
# quantisation
# --------------------------------------------------------------------------
def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-3, 3, (2, 5, 3, 1))
    x[0, 0, 0] = 0.0                                   # an empty vector
    # exact halves: amax 127 gives scale 1, so x / scale is x itself
    x[1, 1, 1] = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                           126.5, -126.5, 0, 1, -1, 4.5, 5.5, 6.5],
                          np.float32)
    x[1, 2, 2] = -x[1, 1, 1]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_matches_reference_exactly(dtype):
    x = _quant_inputs()
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.to(torch.float32).numpy()).astype(dtype)
    tq, ts = t_attn._quant_kv(tx)
    jq, js = j_attn._quant_kv(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # round half to even, as jnp.round
    assert tq[1, 1, 1].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -126,
                                    0, 1, -1, 4, 6, 6]
    assert not bool(tq[0, 0, 0].any())
    for out in ("float32", "bfloat16"):
        got = t_attn._dequant_kv(tq, ts, getattr(torch, out))
        want = j_attn._dequant_kv(jq, js, jnp.dtype(out))
        np.testing.assert_array_equal(_np(got), _np(want))


def test_prefill_slots_quantise_as_the_reference():
    """``_to_decode_cache`` on identical raw (k, v) — a dense cache and a
    rolling buffer shorter than the prompt: the same int8 values and
    scales, empty slots included."""
    for arch in ("deepseek-7b", "mixtral-8x7b"):
        jcfg, tcfg = _configs(arch)
        rng = np.random.default_rng(3)
        s = 24
        raw = {n: rng.standard_normal((2, s, jcfg.num_kv_heads,
                                       jcfg.head_dim)).astype(np.float32)
               for n in ("k", "v")}
        pos = np.arange(s)
        for cache_len in (40, 16):
            want = j_decoding._to_decode_cache(
                {n: jnp.asarray(a) for n, a in raw.items()}, jcfg, "attn",
                cache_len, jnp.asarray(pos))
            got = t_decoding._to_decode_cache(
                {n: torch.from_numpy(a) for n, a in raw.items()}, tcfg,
                "attn", cache_len, torch.as_tensor(pos))
            assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
            for n in want:
                assert str(got[n].dtype).split(".")[-1] == str(want[n].dtype)
                np.testing.assert_array_equal(got[n].numpy(),
                                              np.asarray(want[n]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    jcfg, tcfg = _configs(arch)
    jc = j_values(j_models.init_caches(jcfg, 3, CACHE))
    tc = param_values(t_models.init_caches(tcfg, 3, CACHE, device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                     tc, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert t_models.cache_slot_axes(tc) == j_models.cache_slot_axes(jc)
    assert dataclasses.asdict(t_models.decode_working_set(tcfg)) == \
        dataclasses.asdict(j_models.decode_working_set(jcfg))


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """The prefill's logits and int8 caches, then four decode steps from
    the reference's own caches carried across."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (BATCH, SEQ))
    ej, et = _frames(jcfg, BATCH)
    jl, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(toks[:, :-4]),
                                       **ej}, jcfg, CACHE)
    tl, tc, tt = t_models.prefill(tp, {"tokens": torch.as_tensor(
        toks[:, :-4]), **et}, tcfg, CACHE)
    assert tt == int(jt)
    _close(tl, jl, MODEL_TOL[dtype])
    _caches_close(tc, jc, dtype)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, MODEL_TOL[dtype])
        _caches_close(tc, jc, dtype)


@pytest.mark.parametrize("arch", ["deepseek-7b", "grok-1-314b"])
def test_int8_kv_cache_decode_parity(arch):
    """tests/test_decode_opt.py's check on the port: bf16, the smoke
    config (a no-drop capacity for the MoE), prefill S - 1 tokens into
    an int8 cache and decode the last; the logits track the bf16
    forward within rel 0.08, as the reference's do on the same weights
    and tokens, and agree with the reference's int8 decode."""
    jcfg, tcfg = _configs(arch)
    if jcfg.num_experts:
        jcfg, tcfg = _configs(arch, moe_capacity_factor=float(
            jcfg.num_experts))
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (BATCH, 32), seed=1)
    rels = []
    for fwd, pre, dec, batch, cast in (
            (j_models.forward, j_models.prefill, j_models.decode_step,
             lambda a: jnp.asarray(a), np.asarray),
            (t_models.forward, t_models.prefill, t_models.decode_step,
             torch.as_tensor, _np)):
        p, cfg = (jp, jcfg) if fwd is j_models.forward else (tp, tcfg)
        kw = {"mode": "prefill"} if fwd is j_models.forward else {}
        ref = cast(fwd(p, {"tokens": batch(toks)}, cfg, **kw))[:, -1]
        _, caches, t = pre(p, {"tokens": batch(toks[:, :-1])}, cfg, 40)
        blk = caches["blocks"][0]
        assert "int8" in str(blk["k"].dtype) and "k_scale" in blk
        got, _ = dec(p, caches, batch(toks[:, -1:]), t, cfg)
        got = cast(got)
        rels.append(np.abs(np.asarray(got, np.float32) - ref).max()
                    / (np.abs(ref).max() + 1e-6))
        rels.append(got)
    want_rel, want, rel, got = rels
    assert want_rel < 0.08 and rel < 0.08, (want_rel, rel)
    np.testing.assert_allclose(got, want, **MODEL_TOL["bfloat16"])


def test_slot_decode_matches_reference():
    """Rows prefilled to 9 and 20 tokens into int8 caches decode six
    steps each at their own positions, in fp32."""
    jcfg, tcfg = _configs("deepseek-7b", "float32")
    jp, tp = _params(jcfg)
    toks = _tokens(jcfg, (BATCH, 28))
    lens = (9, 20)
    rows = [j_models.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n])},
                             jcfg, CACHE)[1] for r, n in enumerate(lens)]
    axes = j_models.cache_slot_axes(rows[0])
    jc = jax.tree.map(lambda ax, *xs: jnp.concatenate(xs, axis=ax), axes,
                      *rows)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(6):
        ts = np.array([n + i for n in lens], np.int32)
        tok = np.stack([toks[r, n + i] for r, n in enumerate(lens)])[:, None]
        jl, jc = j_models.slot_decode_step(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(ts), jcfg)
        tl, tc = t_models.slot_decode_step(tp, tc, torch.as_tensor(tok),
                                           torch.as_tensor(ts), tcfg)
        _close(tl, jl, MODEL_TOL["float32"])
        _caches_close(tc, jc, "float32")


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def _engines(arch, dtype, **kw):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServeEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(7):
        plen = (24, 11, 40)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6))
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6))
    return jeng, teng


def test_engine_matches_reference_engine_fp32():
    """deepseek-7b's smoke config with an int8 cache, fp32, temperature
    0: the engine scatters each prefill's int8 values and scales into
    the slot caches, and the tokens, step log (the oracle's cycles over
    a KV stream of 2 x n_kv x (hd + 4) bytes a token) and stats are the
    reference engine's."""
    jeng, teng = _engines("deepseek-7b", "float32", cache_len=56,
                          max_slots=3, eos_id=-1, temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    assert {r.kind for r in teng.step_log} >= {"prefill", "decode",
                                               "mixed"}
    cfg = teng.cfg
    assert teng.kv.token_bytes == cfg.num_layers * 2 * cfg.num_kv_heads * (
        cfg.head_dim + 4)


def test_engine_stats_and_cycles_match_reference_bf16():
    jeng, teng = _engines("deepseek-7b", "bfloat16", cache_len=56,
                          max_slots=3, eos_id=-1, temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    keep = ("step", "kind", "cycles", "sim_time_s", "active", "admitted",
            "finished", "llc_hit_rate")
    assert [{k: r.to_record()[k] for k in keep} for r in teng.step_log] == \
        [{k: r.to_record()[k] for k in keep} for r in jeng.step_log]


def test_serve_cli_runs_an_int8_cache_on_cpu(capsys):
    from repro_torch.serve.__main__ import main as serve_main

    serve_main(["--arch", "deepseek-7b", "--kv-cache-dtype", "int8",
                "--device", "cpu", "--requests", "3", "--prompt-len", "12",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=deepseek-7b-smoke  device=cpu" in out and "kv=int8" in out
    assert "simulated SoC:" in out


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------
@pytest.mark.gpu
def test_int8_decode_through_kernel_prefill_on_card(monkeypatch):
    """bf16 on the card: a prefill through the Hopper kernel into int8
    caches, then four decode steps, against the same run through the
    plain version.  The first layer's int8 values are equal (no
    attention before them); later layers' K/V carry the kernel's bf16
    differences, so they are held dequantised at the bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.swa import kernel as t_swa_kernel
    from repro_torch.kernels.swa import ops as t_swa_ops

    dev = torch.device("cuda")
    _, cfg = _configs("deepseek-7b")
    params = param_values(t_models.init_params(0, cfg, device=dev))
    toks = torch.as_tensor(_tokens(cfg, (3, 137)), device=dev)

    def run():
        logits, caches, t = t_models.prefill(params, {"tokens": toks[:, :-4]},
                                             cfg, 160)
        out = [logits]
        for i in range(4):
            lg, caches = t_models.decode_step(
                params, caches, toks[:, 133 + i:134 + i], t + i, cfg)
            out.append(lg)
        return torch.stack(out), caches

    before = t_swa_kernel.launches
    got, got_c = run()
    assert t_swa_kernel.launches == before + cfg.num_layers
    monkeypatch.setattr(t_swa_ops, "swa_attention",
                        t_swa_ops.swa_attention_plain)
    want, want_c = run()
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), MODEL_TOL["bfloat16"])
    got_c, want_c = got_c["blocks"][0], want_c["blocks"][0]
    assert got_c["k"].dtype == torch.int8
    for name in ("k", "v"):
        assert torch.equal(got_c[name][0], want_c[name][0])
        assert torch.equal(got_c[name + "_scale"][0],
                           want_c[name + "_scale"][0])
        _close(t_attn._dequant_kv(got_c[name], got_c[name + "_scale"],
                                  torch.float32).cpu(),
               t_attn._dequant_kv(want_c[name], want_c[name + "_scale"],
                                  torch.float32).cpu(),
               MODEL_TOL["bfloat16"])

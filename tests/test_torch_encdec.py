"""The port's encoder-decoder stack (whisper-tiny; smoke config) against
the reference.

The encoder runs non-causal self-attention over precomputed frame
embeddings with the sinusoid added; each decoder layer adds a
cross-attention to the encoder output, whose k/v the prefill caches
once (``{"self": ..., "cross": ...}``) and every decode step reads.
Both are plain torch in the port (the reference computes them outside
its Pallas kernel); the decoder's causal self-attention is the ``swa``
op.  Weights cross with ``repro_torch.convert.model_tree`` and both
packages get the same numpy-made tokens and frames.  Attention holds
the reference's at 1e-5 in fp32 and 2e-2 in bf16; the encoder output,
the model's forward, prefill caches and decode steps at 1e-4 in fp32
and, in bf16, at rtol 2e-2 / atol 0.08 (the port's other bf16 model
tests' floor); the port's own decode holds its forward at
tests/test_decode_parity.py's tolerances.  The serving engine takes the
frames as per-request ``extras`` and gives the reference engine's
tokens, step log and ``EngineStats``."""
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.kernels.swa import ops as t_swa_ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.types import param_values  # noqa: E402

ARCH = "whisper-tiny"
ATTEND_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=0.08)}
BATCH, SEQ, CACHE = 2, 24, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype):
    return (dataclasses.replace(j_smoke(ARCH), dtype=dtype),
            dataclasses.replace(t_smoke(ARCH), dtype=dtype))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg, tcfg = _configs(dtype)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return dtype, jcfg, tcfg, jp, tp


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _act(jcfg, shape, seed):
    """Activations rounded to the compute dtype once, in both packages."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(t_layers.compute_dtype(jcfg))
    return jnp.asarray(_np(t)).astype(jnp.dtype(jcfg.dtype)), t


def _frames(cfg, b, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks, frames):
    return ({"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            {"tokens": torch.as_tensor(toks),
             "frames": torch.from_numpy(frames)})


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _layer(jtree, ttree, key, i=0):
    return (jax.tree.map(lambda a: a[i], jtree["blocks"][0][key]),
            t_tf.layer(ttree["blocks"][0][key], i))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def test_cross_attention_matches_reference(pair, monkeypatch):
    """Queries over an encoder output (no RoPE, every key): the
    reference's output and (k, v), with no call of the causal swa op."""
    dtype, jcfg, tcfg, jp, tp = pair
    ja, ta = _layer(jp, tp, "xattn")
    jx, tx = _act(jcfg, (BATCH, SEQ, jcfg.d_model), 8)
    je, te = _act(jcfg, (BATCH, jcfg.encoder_len, jcfg.d_model), 9)
    monkeypatch.setattr(t_swa_ops, "swa_attention", None)
    want, (jk, jv) = j_attn.attend(ja, jx, jcfg,
                                   positions=jnp.arange(SEQ), causal=False,
                                   kv_src=je, return_kv=True)
    got, (tk, tv) = t_attn.attend(ta, tx, tcfg, positions=torch.arange(SEQ),
                                  causal=False, kv_src=te, return_kv=True)
    assert tuple(tk.shape) == (BATCH, jcfg.encoder_len, jcfg.num_kv_heads,
                               jcfg.head_dim)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        _close(g, w, ATTEND_TOL[dtype])


def test_non_causal_self_attention_matches_reference(pair):
    """The encoder's attention: every query sees every key."""
    dtype, jcfg, tcfg, jp, tp = pair
    ja, ta = (jax.tree.map(lambda a: a[1], jp["encoder"]["blocks"][0]["attn"]),
              t_tf.layer(tp["encoder"]["blocks"][0]["attn"], 1))
    jx, tx = _act(jcfg, (BATCH, jcfg.encoder_len, jcfg.d_model), 10)
    pos = np.arange(jcfg.encoder_len)
    want = j_attn.attend(ja, jx, jcfg, positions=jnp.asarray(pos),
                         causal=False)
    got = t_attn.attend(ta, tx, tcfg, positions=torch.as_tensor(pos),
                        causal=False)
    _close(got, want, ATTEND_TOL[dtype])


def test_cross_attention_decode_matches_reference(pair):
    """One decode query per row over a cross cache: the reference's
    output, and the self cache passed through untouched."""
    dtype, jcfg, tcfg, jp, tp = pair
    ja, ta = _layer(jp, tp, "xattn")
    jx, tx = _act(jcfg, (BATCH, 1, jcfg.d_model), 11)
    jk, tk = _act(jcfg, (BATCH, jcfg.encoder_len, jcfg.num_kv_heads,
                         jcfg.head_dim), 12)
    jv, tv = _act(jcfg, tuple(jk.shape), 13)
    marker = {"k": torch.zeros(1)}
    want, _ = j_attn.attend_decode(ja, jx, jcfg, None, jnp.asarray(5),
                                   cross_cache={"k": jk, "v": jv})
    got, passed = t_attn.attend_decode(ta, tx, tcfg, marker, 5,
                                       cross_cache={"k": tk, "v": tv})
    assert passed is marker
    _close(got, want, MODEL_TOL[dtype])


# --------------------------------------------------------------------------
# the encoder and the model
# --------------------------------------------------------------------------
def test_encode_matches_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    frames = _frames(jcfg, BATCH)
    want = j_tf.encode(jp, jnp.asarray(frames), jcfg)
    got = t_tf.encode(tp, torch.from_numpy(frames), tcfg)
    assert got.dtype == t_layers.compute_dtype(tcfg)
    assert tuple(got.shape) == want.shape
    _close(got, want, MODEL_TOL[dtype])


def test_sinusoid_matches_reference():
    """The frequencies come from each framework's fp32 ``exp``, which
    differ by an ulp; at position p that moves an angle by ~p * 6e-8
    rad, so the tolerance grows with the position (1.2e-4 at 1,499)."""
    for d in (64, 384, 7):
        for p in (0, 1, 5, 223, 1499):
            pos = np.array([p])
            np.testing.assert_allclose(
                t_tf._sinusoid(torch.as_tensor(pos), d).numpy(),
                np.asarray(j_tf._sinusoid(jnp.asarray(pos), d)),
                rtol=0, atol=2e-6 + p * 1.2e-7)


def test_forward_matches_reference(pair):
    dtype, jcfg, tcfg, jp, tp = pair
    jb, tb = _batches(jcfg, _tokens(jcfg, (BATCH, SEQ)), _frames(jcfg, BATCH))
    want = j_models.forward(jp, jb, jcfg, mode="prefill")
    got = t_models.forward(tp, tb, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, MODEL_TOL[dtype])


def test_prefill_logits_and_caches_match_reference(pair):
    """Logits, the decoder's dense self caches and the cross caches (the
    encoder output's k/v, ``encoder_len`` rows a layer)."""
    dtype, jcfg, tcfg, jp, tp = pair
    jb, tb = _batches(jcfg, _tokens(jcfg, (BATCH, SEQ)), _frames(jcfg, BATCH))
    jl, jc, jt = j_models.prefill(jp, jb, jcfg, CACHE)
    tl, tc, tt = t_models.prefill(tp, tb, tcfg, CACHE)
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
    cross = tc["blocks"][0]["cross"]["k"]
    assert tuple(cross.shape) == (jcfg.num_layers, BATCH, jcfg.encoder_len,
                                  jcfg.num_kv_heads, jcfg.head_dim)


def test_decode_steps_match_reference(pair):
    """Four steps from the reference's own prefill caches, carried
    across: ``decode_step`` in both packages (the sinusoid at the
    step's position, the cross caches read each step)."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    jb, _ = _batches(jcfg, toks[:, :-4], _frames(jcfg, BATCH))
    _, jc, jt = j_models.prefill(jp, jb, jcfg, CACHE)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


def test_slot_decode_matches_reference(pair):
    """Rows prefilled to 9 and 20 tokens over their own frames decode
    six steps each with a position (and a sinusoid) per row."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, 28))
    frames = _frames(jcfg, BATCH)
    lens = (9, 20)
    rows = [j_models.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n]),
                                  "frames": jnp.asarray(frames[r:r + 1])},
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
        _close(tl, jl, MODEL_TOL[dtype])


def test_decode_matches_forward():
    """tests/test_decode_parity.py's checks on the port (bf16): one
    decode step after an S - 1 prefill against the forward's last
    position, then four steps carried across from a 28-token prefill
    at the multi-step tolerance."""
    cfg = t_smoke(ARCH)
    params = param_values(t_models.init_params(0, cfg, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg, (BATCH, 32), seed=2))
    frames = torch.from_numpy(_frames(cfg, BATCH, seed=3))
    full = t_models.forward(params, {"tokens": toks, "frames": frames}, cfg)
    _, caches, t = t_models.prefill(
        params, {"tokens": toks[:, :-1], "frames": frames}, cfg, 40)
    got, _ = t_models.decode_step(params, caches, toks[:, -1:], t, cfg)
    _close(got, full[:, -1], dict(rtol=2e-2, atol=2e-2))
    _, caches, t = t_models.prefill(
        params, {"tokens": toks[:, :28], "frames": frames}, cfg, 40)
    for i in range(4):
        got, caches = t_models.decode_step(params, caches,
                                           toks[:, 28 + i:29 + i], t + i, cfg)
        _close(got, full[:, 28 + i], dict(rtol=7e-2, atol=7e-2))


def test_trees_caches_and_working_sets_match_reference():
    """The parameter tree (encoder subtree, ``norm_x`` and ``xattn`` in
    each decoder layer), ``init_caches``' nested layout and slot axes,
    configs and the decode working set (cross k/v as per-step state)."""
    assert ARCH in ARCHS
    for jcfg, tcfg in ((j_get(ARCH), get_config(ARCH)),
                       (j_smoke(ARCH), t_smoke(ARCH))):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert dataclasses.asdict(j_models.decode_working_set(jcfg)) == \
            dataclasses.asdict(t_models.decode_working_set(tcfg))
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(3), jcfg))
    own = param_values(t_models.init_params(0, tcfg, device="cpu"))
    jl, jdef = jax.tree.flatten(jp)
    ol, odef = jax.tree.flatten(
        own, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert odef == jdef
    assert [tuple(o.shape) for o in ol] == [j.shape for j in jl]
    jc = j_values(j_models.init_caches(jcfg, 3, CACHE))
    tc = param_values(t_models.init_caches(tcfg, 3, CACHE, device="cpu"))
    jl, jdef = jax.tree.flatten(jc)
    tl, tdef = jax.tree.flatten(
        tc, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert tdef == jdef
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tl] == \
        [(j.shape, str(j.dtype)) for j in jl]
    assert t_models.cache_slot_axes(tc) == j_models.cache_slot_axes(jc)


# --------------------------------------------------------------------------
# serving with frames as extras
# --------------------------------------------------------------------------
def _engines(dtype, **kw):
    jcfg, tcfg = _configs(dtype)
    jparams = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(7):
        plen = (24, 11, 40)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        frames = {"frames": _frames(tcfg, 1, seed=20 + i)[0]}
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6), extras=frames)
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6), extras=frames)
    return jeng, teng


def test_engine_matches_reference_engine_fp32():
    """whisper's smoke config in fp32 at temperature 0, each request
    with its own frames: identical tokens, step log (oracle cycles
    included) and ``EngineStats``; the extras leave with their
    requests."""
    jeng, teng = _engines("float32", cache_len=56, max_slots=3, eos_id=-1,
                          temperature=0.0)
    assert sorted(teng._extras) == list(range(7))
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    assert teng._extras == {}


def test_engine_stats_and_cycles_match_reference_bf16():
    """bf16 with no EOS: ``EngineStats`` and every step's kind, cycles,
    admissions and occupancy are the reference's."""
    jeng, teng = _engines("bfloat16", cache_len=56, max_slots=3, eos_id=-1,
                          temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    keep = ("step", "kind", "cycles", "sim_time_s", "active", "admitted",
            "finished", "llc_hit_rate")
    assert [{k: r.to_record()[k] for k in keep} for r in teng.step_log] == \
        [{k: r.to_record()[k] for k in keep} for r in jeng.step_log]


def test_engine_prefill_stacks_each_groups_frames():
    """A same-length group's prefill batch holds its requests' own
    frames, in the group's order."""
    _, tcfg = _configs("float32")
    params = param_values(t_models.init_params(0, tcfg, device="cpu"))
    eng = ServeEngine(tcfg, params, cache_len=32, max_slots=3, eos_id=-1,
                      device="cpu")
    seen = []
    real = eng._prefill

    def spy(p, batch):
        seen.append((tuple(batch["tokens"].shape), batch["frames"].clone()))
        return real(p, batch)

    eng._prefill = spy
    frames = [_frames(tcfg, 1, seed=30 + i)[0] for i in range(3)]
    for i, n in enumerate((8, 5, 8)):
        eng.submit(Request(rid=i, tokens=(3,) * n, max_new=2),
                   extras={"frames": frames[i]})
    eng.step()
    assert [s for s, _ in seen] == [(1, 5), (2, 8)]
    np.testing.assert_array_equal(seen[0][1].numpy(), frames[1][None])
    np.testing.assert_array_equal(seen[1][1].numpy(),
                                  np.stack([frames[0], frames[2]]))


def test_serve_cli_runs_whisper_on_cpu(capsys):
    from repro_torch.serve.__main__ import main as serve_main

    serve_main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--prompt-len", "12", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke  device=cpu" in out
    assert "simulated SoC:" in out


@pytest.mark.gpu
def test_prefill_through_kernel_matches_plain_on_card(monkeypatch):
    """bf16 prefill on the card: the decoder's causal self-attention
    through the Hopper kernel (one launch per decoder layer; the encoder
    and the cross-attention are plain torch) against the same prefill
    through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.swa import kernel as t_swa_kernel

    dev = torch.device("cuda")
    cfg = t_smoke(ARCH)
    params = param_values(t_models.init_params(0, cfg, device=dev))
    batch = {"tokens": torch.as_tensor(_tokens(cfg, (3, 137)), device=dev),
             "frames": torch.from_numpy(_frames(cfg, 3)).to(dev)}
    before = t_swa_kernel.launches
    got, _, _ = t_models.prefill(params, batch, cfg, 160)
    assert t_swa_kernel.launches == before + cfg.num_layers
    monkeypatch.setattr(t_swa_ops, "swa_attention",
                        t_swa_ops.swa_attention_plain)
    want, _, _ = t_models.prefill(params, batch, cfg, 160)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), MODEL_TOL["bfloat16"])

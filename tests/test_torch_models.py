"""The port's mamba-2 model (smoke config) against the reference.

The reference's weights are carried across with
``repro_torch.convert.model_tree`` and both packages get the same
numpy-made tokens.  In fp32 the port holds the reference's forward,
prefill logits and caches, ``decode_step`` and ``slot_decode_step`` at
rtol = atol = 1e-4, with one SSM group and with several; at the default
bf16 it holds them at the reference's own decode-parity tolerances (tests/test_decode_parity.py:
atol 0.08 / rtol 2e-2 for one step, atol 0.3 / rtol 7e-2 over four),
since the two frameworks round bf16 at different points."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import models as j_models  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.types import param_axes, param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.kernels.ssd import kernel as t_ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as t_ssd_ops  # noqa: E402
from repro_torch.types import is_param, param_values, tree_map  # noqa: E402

ARCH = "mamba2-130m"
FP32 = dict(rtol=1e-4, atol=1e-4)
BF16_ONE = dict(rtol=2e-2, atol=0.08)
BF16_MULTI = dict(rtol=7e-2, atol=0.3)
# 68 tokens is no multiple of the 32-token chunk: one chunk of 68; the
# decode test's 64-token prefill runs two chunks
BATCH, SEQ, CACHE = 2, 68, 80


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
    jcfg, tcfg = _configs(request.param)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (BATCH, SEQ))
    return request.param, jcfg, tcfg, jp, tp, toks


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tol(dtype, multi=False):
    if dtype == "float32":
        return FP32
    return BF16_MULTI if multi else BF16_ONE


def test_forward_matches_reference(pair):
    dtype, jcfg, tcfg, jp, tp, toks = pair
    want = j_models.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill")
    got = t_models.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # a full-sequence forward is many bf16 steps deep: the multi-step bound
    _close(got, want, _tol(dtype, multi=True))


def test_prefill_logits_and_caches_match_reference(pair):
    dtype, jcfg, tcfg, jp, tp, toks = pair
    jl, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                  CACHE)
    tl, tc, tt = t_models.prefill(tp, {"tokens": torch.as_tensor(toks)},
                                  tcfg, CACHE)
    assert tt == int(jt) == SEQ
    _close(tl, jl, _tol(dtype))
    assert len(tc["blocks"]) == len(jc["blocks"]) == 1
    for key in ("conv", "state"):
        got, want = tc["blocks"][0][key], jc["blocks"][0][key]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(tc["blocks"][0]["state"], jc["blocks"][0]["state"],
           FP32 if dtype == "float32" else BF16_MULTI)
    # the conv tail is stored bf16 in both: in fp32 at most a bf16
    # rounding apart; at bf16 the one-step bound
    _close(tc["blocks"][0]["conv"], jc["blocks"][0]["conv"],
           dict(rtol=1e-2, atol=1e-2) if dtype == "float32" else BF16_ONE)


def test_decode_steps_match_reference(pair):
    """Four steps from the reference's own prefill caches, carried
    across: ``decode_step`` and ``slot_decode_step`` in both packages."""
    dtype, jcfg, tcfg, jp, tp, toks = pair
    pre = toks[:, :SEQ - 4]
    _, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(pre)}, jcfg,
                                 CACHE)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    jc_slot, tc_slot = jc, tc
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        ts = np.full(BATCH, t, np.int32)
        jls, jc_slot = j_models.slot_decode_step(
            jp, jc_slot, jnp.asarray(tok), jnp.asarray(ts), jcfg)
        tls, tc_slot = t_models.slot_decode_step(
            tp, tc_slot, torch.as_tensor(tok), torch.as_tensor(ts), tcfg)
        tol = _tol(dtype, multi=i > 0)
        _close(tl, jl, tol)
        _close(tls, jls, tol)
        _close(tc["blocks"][0]["state"], jc["blocks"][0]["state"], tol)


def test_params_and_caches_keep_the_reference_layout():
    jcfg, tcfg = _configs("bfloat16")
    jparams = j_models.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = t_models.init_params(0, tcfg, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape, j_values(jparams))
    tshapes = jax.tree.map(lambda a: tuple(a.shape),
                           param_values(tparams),
                           is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert tshapes == jshapes
    taxes = tree_map(lambda p: p.axes, tparams, is_leaf=is_param)
    jaxes = jax.tree.map(lambda a: a.axes, param_axes(jparams))
    assert taxes == jaxes
    assert all(v.dtype == torch.float32
               for v in jax.tree.leaves(param_values(tparams)))
    jcache = j_values(j_models.init_caches(jcfg, 3, 40))
    tcache = param_values(t_models.init_caches(tcfg, 3, 40, device="cpu"))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jcache) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                     tcache, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert t_models.cache_slot_axes(tcache) == \
        j_models.cache_slot_axes(jcache)


def test_working_set_and_registry_match_reference():
    from repro.configs import get_config as j_get

    assert ARCHS == ("mamba2-130m", "recurrentgemma-9b", "qwen2-0.5b",
                     "deepseek-7b", "granite-3-8b", "chatglm3-6b",
                     "whisper-tiny", "mixtral-8x7b", "grok-1-314b",
                     "internvl2-26b")
    for get in (lambda a: (j_get(a), get_config(a)),
                lambda a: (j_smoke(a), t_smoke(a))):
        jcfg, tcfg = get(ARCH)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert dataclasses.asdict(j_models.decode_working_set(jcfg)) == \
            dataclasses.asdict(t_models.decode_working_set(tcfg))
    ws = t_models.decode_working_set(get_config(ARCH))
    assert (ws.weight_bytes, ws.state_bytes, ws.kv_entries) == \
        (257_842_560, 19_132_416, ())


def test_unported_block_kinds_raise():
    """A block kind the reference does not have raises by name; what the
    port once refused here runs as the reference does: attention blocks
    with an int8 KV cache (deepseek-7b's) and SSM blocks with 2 SSM
    groups (fp32 forward)."""
    bad = dataclasses.replace(t_smoke(ARCH), block_pattern=("conv",))
    with pytest.raises(NotImplementedError, match="'conv'.*block kinds"):
        t_models.init_params(0, bad, device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, (2, 24))
    for arch, kw in (("deepseek-7b", dict(kv_cache_dtype="int8")),
                     (ARCH, dict(ssm_ngroups=2))):
        jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", **kw)
        tcfg = dataclasses.replace(t_smoke(arch), dtype="float32", **kw)
        jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
        tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
        want = j_models.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                mode="prefill")
        got = t_models.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
        _close(got, want, FP32)


@pytest.fixture(scope="module",
                params=[(g, d) for g in (2, 4) for d in ("float32",
                                                         "bfloat16")],
                ids=lambda p: f"g{p[0]}-{p[1]}")
def grouped(request):
    g, dtype = request.param
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype=dtype, ssm_ngroups=g)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype=dtype, ssm_ngroups=g)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (BATCH, SEQ))
    return dtype, jcfg, tcfg, jp, tp, toks


def test_grouped_ssm_matches_reference(grouped):
    """``ssm_ngroups`` 2 and 4 over the smoke config's 4 SSM heads (2
    heads a group, one head a group): the forward, the prefill's logits
    and caches, and four decode steps, each from the reference's caches
    of the step before (the conv tail is stored in bf16, so a cache the
    port carried on could hold one element rounded the other way), at
    the single-group model's tolerances."""
    dtype, jcfg, tcfg, jp, tp, toks = grouped
    want = j_models.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="prefill")
    got = t_models.forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    _close(got, want, _tol(dtype, multi=True))
    jl, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(
        toks[:, :-4])}, jcfg, CACHE)
    tl, tc, tt = t_models.prefill(tp, {"tokens": torch.as_tensor(
        toks[:, :-4])}, tcfg, CACHE)
    assert tt == int(jt)
    _close(tl, jl, _tol(dtype))
    conv = tc["blocks"][0]["conv"]
    assert conv.shape[-1] == jcfg.ssm_d_inner + 2 * jcfg.ssm_ngroups \
        * jcfg.ssm_state == jc["blocks"][0]["conv"].shape[-1]
    _close(tc["blocks"][0]["state"], jc["blocks"][0]["state"],
           FP32 if dtype == "float32" else BF16_MULTI)
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, _tol(dtype, multi=i > 0))
        _close(tc["blocks"][0]["state"], jc["blocks"][0]["state"],
               _tol(dtype, multi=i > 0))


def test_grouped_ssm_engine_matches_reference_engine_fp32():
    """Serving with 2 SSM groups, fp32, temperature 0: the tokens, step
    log and stats of the reference engine."""
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve import Request, ServeEngine

    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32", ssm_ngroups=2)
    tcfg = dataclasses.replace(t_smoke(ARCH), dtype="float32", ssm_ngroups=2)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(cache_len=80, max_slots=3, eos_id=-1, temperature=0.0)
    jeng, teng = JEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp,
                                                      device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(5):
        toks = tuple(int(t) for t in rng.integers(3, 256, (24, 64, 40)[i % 3]))
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6))
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6))
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished


@pytest.mark.gpu
def test_prefill_through_kernel_matches_plain_on_card(monkeypatch):
    """bf16 prefill on the card: the SSD step through the Hopper kernel
    (one launch per layer) against the same prefill through the plain
    version, at the one-step bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    _, tcfg = _configs("bfloat16")
    params = param_values(t_models.init_params(0, tcfg, device=dev))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (3, 72)), device=dev)
    before = t_ssd_kernel.launches
    got, _, _ = t_models.prefill(params, {"tokens": toks}, tcfg, 80)
    assert t_ssd_kernel.launches == before + tcfg.num_layers

    monkeypatch.setattr(t_ssd_ops, "ssd_intra_chunk",
                        t_ssd_ops.ssd_intra_chunk_plain)
    want, _, _ = t_models.prefill(params, {"tokens": toks}, tcfg, 80)
    assert t_ssd_kernel.launches == before + tcfg.num_layers
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), BF16_ONE)

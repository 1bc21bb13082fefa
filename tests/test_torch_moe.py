"""The port's top-k MoE FFN (``repro_torch.models.moe``) and the MoE
family (mixtral-8x7b, grok-1-314b; smoke configs) against the
reference.

Routing is held exactly: from the same fp32 router probabilities both
packages pick the same experts (ties to the lower index), the same
renormalised gates, the same slot positions and drop the same
token-choices, in both grouping branches (groups of 512 tokens, one
group of all tokens) and with a zero router, where every probability
ties.  From the same fp32 logits the choices, positions and drops are
the same and the gates agree to an ulp of the two frameworks' ``exp``.
``apply_moe`` holds the reference's at 1e-5 in fp32 and 2e-2 in bf16;
the model's forward, prefill caches and decode steps at 1e-4 in fp32
and, in bf16, at rtol 2e-2 / atol 0.08 (the port's other bf16 model
tests' floor: the frameworks round bf16 at different points).  The
port's own decode holds its forward at tests/test_decode_parity.py's
tolerances, with that test's no-drop capacity factor.  The slot decode
routes each row as its own group, as the reference's ``vmap`` of a
batch-1 step does, at 8 slots with every row on one expert."""
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
from repro.models import moe as j_moe  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.types import param_values  # noqa: E402

MOE = ("mixtral-8x7b", "grok-1-314b")
MOE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
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


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(j_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(t_smoke(arch), dtype=dtype, **kw))


def _np(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _moe_params(jcfg, seed=0):
    jp = jax.tree.map(lambda p: p.value,
                      j_moe.init_moe(jax.random.PRNGKey(seed), jcfg),
                      is_leaf=lambda p: hasattr(p, "axes"))
    return jp, model_tree(jax.tree.map(np.asarray, jp), device="cpu")


def _act(jcfg, shape, seed, shared=0.0):
    """Unit-variance activations rounded to the compute dtype once, in
    both packages; a ``shared`` share of each is a component common to
    every token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x = np.sqrt(1 - shared ** 2) * x + shared * rng.standard_normal(
        shape[-1:]).astype(np.float32)
    t = torch.from_numpy(x).to(t_layers.compute_dtype(jcfg))
    return jnp.asarray(_np(t)).astype(jnp.dtype(jcfg.dtype)), t


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def _ref_routing(probs, cfg, c, dt=jnp.float32):
    """The reference's routing, line for line from
    ``repro.models.moe.apply_moe`` (top-k, renormalisation, GShard slot
    positions, the capacity test and ``combine > 0``), on given fp32
    probabilities (g, t, E): (experts, gates, positions, fits, kept),
    each (g, t, k)."""
    g, t, e = probs.shape
    k = cfg.num_experts_per_tok
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.clip(
        jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.float32)
    flat = onehot.swapaxes(1, 2).reshape(g, k * t, e)
    pos_in_expert = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos_in_expert * flat, axis=-1).astype(jnp.int32)
    fits = (pos < c) & (jnp.max(flat, axis=-1) > 0)
    pos = pos.reshape(g, k, t).swapaxes(1, 2)
    fits = fits.reshape(g, k, t).swapaxes(1, 2)
    kept = fits & (gate_vals.astype(dt) > 0)
    return expert_idx, gate_vals, pos, fits, kept


def _routing_logits(case, e):
    """Router logits (g, t, E) in fp32 for a routing case: the
    512-token groups of a 1,024-token call, one group of 300, a zero
    router (every probability ties) and bf16 logits on a coarse grid
    (many ties).  The random logits lean towards the higher experts (a
    router's usual imbalance), so the capacity drops choices."""
    rng = np.random.default_rng(3)
    lean = np.linspace(0.0, 1.5, e, dtype=np.float32)
    if case == "groups_of_512":
        return rng.standard_normal((2, 512, e)).astype(np.float32) * 2 + lean
    if case == "one_group":
        return rng.standard_normal((1, 300, e)).astype(np.float32) * 2 + lean
    if case == "zero_router":
        return np.zeros((1, 64, e), np.float32)
    coarse = np.round(rng.standard_normal((1, 256, e)) * 2 + lean) / 2
    return np.array(torch.from_numpy(coarse.astype(np.float32))
                    .to(torch.bfloat16).float())


ROUTING_CASES = ("groups_of_512", "one_group", "zero_router", "ties")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_on_identical_probabilities_is_exact(arch, case):
    """Experts, renormalised gates, slot positions, what fits and what
    is kept: equal, bit for bit, from the same fp32 probabilities; and
    some token-choices are dropped in every case."""
    cfg = get_config(arch)
    logits = _routing_logits(case, cfg.num_experts)
    g, t, _ = logits.shape
    c = t_moe._capacity(t, cfg)
    assert c == j_moe._capacity(t, cfg)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want = _ref_routing(jnp.asarray(probs), cfg, c)
    got = t_moe.route(torch.from_numpy(probs), cfg, c)
    np.testing.assert_array_equal(got.expert.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.gate.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got.fits.numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(
        (got.fits & (got.gate > 0)).numpy(), np.asarray(want[4]))
    assert not bool(got.fits.all())          # the capacity drops choices
    if case == "zero_router":
        # every token picks experts 0 and 1; past the capacity, both of
        # its choices are dropped
        assert (got.expert.numpy() == [0, 1]).all()
        assert bool(got.fits[:, :c].all()) and not bool(got.fits[:, c:].any())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_on_identical_logits(arch, case):
    """From the same fp32 logits, through each package's own softmax:
    the same experts, positions and drops; gates within the ulp by
    which the two frameworks' ``exp`` differ (exactly equal where every
    logit ties)."""
    cfg = get_config(arch)
    logits = _routing_logits(case, cfg.num_experts)
    c = t_moe._capacity(logits.shape[1], cfg)
    want = _ref_routing(jax.nn.softmax(jnp.asarray(logits), axis=-1), cfg, c)
    got = t_moe.route(torch.softmax(torch.from_numpy(logits), dim=-1), cfg, c)
    np.testing.assert_array_equal(got.expert.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got.fits.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want[1]),
                               rtol=4e-7, atol=0)
    if case == "zero_router":
        np.testing.assert_array_equal(got.gate.numpy(), 0.5)


def test_group_sizes_and_capacities_match_reference():
    """Groups of 512 when the tokens are a larger multiple of 512, else
    one group; the capacity rounded up to a multiple of 4, at least 4
    — at the serving shapes of mixtral-8x7b (two 5,120-token prompts,
    two of 4,200, one decode token) and at smoke sizes."""
    cfg = get_config("mixtral-8x7b")
    for tokens, group, cap in ((10240, 512, 160), (8400, 8400, 2628),
                               (5120, 512, 160), (4200, 4200, 1312),
                               (512, 512, 160), (1, 1, 4), (8, 8, 4)):
        assert t_moe.group_size(tokens) == group
        assert t_moe._capacity(group, cfg) == j_moe._capacity(group, cfg) \
            == cap


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------
def _dropped(tp, tx, tcfg):
    """Token-choices the port's routing drops for ``tx`` (B, S, d)."""
    b, s, d = tx.shape
    group = t_moe.group_size(b * s)
    xg = tx.reshape(-1, group, d)
    r = t_moe.route(t_moe.router_probs(tp, xg), tcfg,
                    t_moe._capacity(group, tcfg))
    return int((~r.fits).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", [(2, 24), (2, 512), (1, 96)],
                         ids=["one_group_48", "groups_of_512", "one_group_96"])
def test_apply_moe_matches_reference(arch, dtype, shape):
    """The default capacity factor, token-choices dropped, both
    grouping branches: the reference's output at 1e-5 (fp32) / 2e-2
    (bf16).  The tokens share a component (hidden states of one text
    do), which leans the router towards some experts past their
    capacity."""
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _moe_params(jcfg)
    jx, tx = _act(jcfg, shape + (jcfg.d_model,), 5, shared=0.8)
    want = j_moe.apply_moe(jp, jx, jcfg)
    got = t_moe.apply_moe(tp, tx, tcfg)
    assert got.dtype == tx.dtype and tuple(got.shape) == tx.shape
    _close(got, want, MOE_TOL[dtype])
    assert _dropped(tp, tx, tcfg) > 0


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_zero_router_drops_as_the_reference(arch):
    """A zero router: every token on experts 0 and 1 with gates 1/2;
    the tokens past the capacity get nothing from the layer, in both
    packages."""
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _moe_params(jcfg)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jx, tx = _act(jcfg, (1, 64, jcfg.d_model), 6)
    want = np.asarray(j_moe.apply_moe(jp, jx, jcfg))
    got = t_moe.apply_moe(tp, tx, tcfg).numpy()
    c = t_moe._capacity(64, tcfg)
    _close(got, want, MOE_TOL["float32"])
    assert not got[0, c:].any() and not want[0, c:].any()
    assert np.abs(got[0, :c]).min(axis=-1).max() > 0


def test_load_balance_loss_matches_reference():
    cfg = get_config("mixtral-8x7b")
    logits = _routing_logits("groups_of_512", cfg.num_experts)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    _, idx = jax.lax.top_k(jnp.asarray(probs), cfg.num_experts_per_tok)
    want = j_moe.load_balance_loss(jnp.asarray(probs), idx, cfg)
    got = t_moe.load_balance_loss(torch.from_numpy(probs),
                                  torch.from_numpy(np.array(idx))
                                  .to(torch.int64), cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
@pytest.fixture(scope="module",
                params=[(a, d) for a in MOE for d in ("float32",
                                                      "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    arch, dtype = request.param
    jcfg, tcfg = _configs(arch, dtype)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return dtype, jcfg, tcfg, jp, tp


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
        _close(got, want, MODEL_TOL[dtype])


def test_decode_steps_match_reference(pair):
    """Four steps from the reference's own prefill caches, carried
    across: ``decode_step`` in both packages, the batch of two routed
    as one group in both."""
    dtype, jcfg, tcfg, jp, tp = pair
    toks = _tokens(jcfg, (BATCH, SEQ))
    _, jc, jt = j_models.prefill(jp, {"tokens": jnp.asarray(toks[:, :-4])},
                                 jcfg, CACHE)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    for i in range(4):
        tok = toks[:, SEQ - 4 + i:SEQ - 3 + i]
        t = int(jt) + i
        jl, jc = j_models.decode_step(jp, jc, jnp.asarray(tok),
                                      jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = t_models.decode_step(tp, tc, torch.as_tensor(tok), t, tcfg)
        _close(tl, jl, MODEL_TOL[dtype])


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    """tests/test_decode_parity.py's check on the port (bf16, its
    no-drop capacity factor): prefill S - 1 tokens, decode the last,
    against the forward's last position; then four steps carried
    across against the forward at the multi-step tolerance."""
    cfg = dataclasses.replace(t_smoke(arch), moe_capacity_factor=float(
        t_smoke(arch).num_experts))
    params = param_values(t_models.init_params(0, cfg, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg, (BATCH, 32), seed=2))
    full = t_models.forward(params, {"tokens": toks}, cfg)
    _, caches, t = t_models.prefill(params, {"tokens": toks[:, :-1]}, cfg,
                                    40)
    got, _ = t_models.decode_step(params, caches, toks[:, -1:], t, cfg)
    _close(got, full[:, -1], dict(rtol=2e-2, atol=2e-2))
    _, caches, t = t_models.prefill(params, {"tokens": toks[:, :28]}, cfg,
                                    40)
    for i in range(4):
        got, caches = t_models.decode_step(params, caches,
                                           toks[:, 28 + i:29 + i], t + i, cfg)
        _close(got, full[:, 28 + i], dict(rtol=7e-2, atol=7e-2))


def test_bf16_logit_gap_is_routing_flips():
    """Why mixtral-8x7b's bf16 first-token logits through the swa kernel
    differ from the plain version's by 1.434 on the card (reported, not
    gated, by chip_smoke.py): mixtral's smoke config in bf16, one
    512-token forward (one routing group), with attention replaced by
    the tensor-core kernel's rounding spec
    (tests/test_torch_swa.py::test_tensor_core_rounding_fits_bf16_tolerance).
    The spec's one-ulp attention differences flip a few of the 2 x 1024
    expert choices; the tokens whose routing flipped move by more than
    1 (the card's order), the others by what the flips reach through
    attention; forcing the spec's run onto the plain run's routing brings
    every position back under 0.1, a dense bf16 model's amplification.
    So the MoE gap is routing flips; the per-layer 2e-2 check and the
    fp32 logit gate stay the kernel checks."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "swa_spec", Path(__file__).resolve().parent / "test_torch_swa.py")
    swa_spec = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(swa_spec)
    from repro_torch.kernels.swa import ops as swa_ops

    cfg = t_smoke("mixtral-8x7b")
    params = param_values(t_models.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"))
    s = 512
    toks = torch.as_tensor([_tokens(cfg, (s,)).tolist()])
    plain, route = swa_ops.swa_attention, t_moe.route

    def tc_spec(q, k, v, *, window, scale, softcap):
        return swa_spec._tc_emulation(q, k, v, window=window, scale=scale,
                                      softcap=softcap)

    def logits(attend, forced=None):
        seen = []

        def recording(probs, c, capacity):
            r = route(probs, c, capacity) if forced is None \
                else forced[len(seen)]
            seen.append(r)
            return r

        swa_ops.swa_attention, t_moe.route = attend, recording
        try:
            out = t_models.forward(params, {"tokens": toks}, cfg)
        finally:
            swa_ops.swa_attention, t_moe.route = plain, route
        return out[0, :, :cfg.vocab_size].float(), seen

    base, base_routes = logits(plain)
    got, got_routes = logits(tc_spec)
    forced, _ = logits(tc_spec, forced=base_routes)
    flips = [int((a.expert != b.expert).sum())
             for a, b in zip(base_routes, got_routes)]
    flipped = torch.zeros(s, dtype=torch.bool)
    for a, b in zip(base_routes, got_routes):
        flipped |= (a.expert != b.expert).any(-1).reshape(-1)
    gap = (got - base).abs().amax(-1)
    forced_gap = float((forced - base).abs().max())
    print(f"mixtral smoke bf16, {s} tokens: expert flips by layer {flips} "
          f"of {base_routes[0].expert.numel()}; logit gap at the "
          f"{int(flipped.sum())} flipped tokens {float(gap[flipped].max()):.4g},"
          f" elsewhere {float(gap[~flipped].max()):.4g}; routing forced "
          f"{forced_gap:.4g}")
    assert 0 < sum(flips) < 0.02 * s * cfg.num_experts_per_tok * len(flips)
    assert float(gap[flipped].max()) > 1.0
    assert forced_gap < 0.1
    assert float(gap.max()) > 10 * forced_gap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_decode_routes_each_row_as_its_own_group(dtype):
    """mixtral's smoke config with its full 8 experts and a zero router
    (every row on experts 0 and 1) at 8 slots: as one group of 8 tokens
    (capacity 4) half the rows would be dropped; the slot decode routes
    each row alone (capacity 4 a row, nothing dropped) and gives the
    reference's ``vmap``ped batch-1 steps, over four steps with rows at
    eight different positions."""
    jcfg, tcfg = _configs("mixtral-8x7b", dtype, num_experts=8)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    zero = lambda tree, z: {**tree, "blocks": tuple(  # noqa: E731
        {**b, "mlp": {**b["mlp"], "router": z(b["mlp"]["router"])}}
        for b in tree["blocks"])}
    jp = zero(jp, jnp.zeros_like)
    tp = model_tree(jax.tree.map(np.asarray, jp), device="cpu")
    assert not bool(tp["blocks"][0]["mlp"]["router"].any())
    rows = 8
    toks = _tokens(jcfg, (rows, 30))
    lens = [6 + 2 * r for r in range(rows)]
    caches = [j_models.prefill(jp, {"tokens": jnp.asarray(toks[r:r + 1, :n])},
                               jcfg, CACHE)[1] for r, n in enumerate(lens)]
    axes = j_models.cache_slot_axes(caches[0])
    jc = jax.tree.map(lambda ax, *xs: jnp.concatenate(xs, axis=ax), axes,
                      *caches)
    tc = model_tree(jax.tree.map(np.asarray, jc), device="cpu")
    grouped_tc = tc
    for i in range(4):
        ts = np.array([n + i for n in lens], np.int32)
        tok = np.stack([toks[r, n + i] for r, n in enumerate(lens)])[:, None]
        jl, jc = j_models.slot_decode_step(jp, jc, jnp.asarray(tok),
                                           jnp.asarray(ts), jcfg)
        tl, tc = t_models.slot_decode_step(tp, tc, torch.as_tensor(tok),
                                           torch.as_tensor(ts), tcfg)
        _close(tl, jl, MODEL_TOL[dtype])
        if i == 0:
            # the same step with the 8 rows routed as one group drops
            # the rows past the capacity of 4 and moves their logits
            gl, _ = t_models.decode_step(tp, grouped_tc, torch.as_tensor(tok),
                                         torch.as_tensor(ts), tcfg)
            moved = (gl - tl).abs().amax(dim=1)
            assert not bool(moved[:4].any()) and bool((moved[4:] > 0.1).all())


# --------------------------------------------------------------------------
# registry, layout, serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_configs_working_sets_and_trees_match_reference(arch):
    """Configs, decode working sets and the parameter tree's layout
    (router, experts stacked per layer) are the reference's."""
    assert arch in ARCHS
    for jcfg, tcfg in ((j_get(arch), get_config(arch)),
                       (j_smoke(arch), t_smoke(arch))):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert dataclasses.asdict(j_models.decode_working_set(jcfg)) == \
            dataclasses.asdict(t_models.decode_working_set(tcfg))
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jp = j_values(j_models.init_params(jax.random.PRNGKey(3), jcfg))
    own = param_values(t_models.init_params(0, tcfg, device="cpu"))
    jl, jdef = jax.tree.flatten(jp)
    ol, odef = jax.tree.flatten(
        own, is_leaf=lambda a: isinstance(a, torch.Tensor))
    assert odef == jdef
    assert [tuple(o.shape) for o in ol] == [j.shape for j in jl]
    mlp = own["blocks"][0]["mlp"]
    assert tuple(mlp["w_in"].shape) == (tcfg.num_layers, tcfg.num_experts,
                                        tcfg.d_model, tcfg.d_ff)


def _engines(dtype, **kw):
    jcfg, tcfg = _configs("mixtral-8x7b", dtype)
    jparams = j_values(j_models.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
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
    """mixtral's smoke config in fp32 at temperature 0: prompts of 24,
    11 and 40 tokens (past the 16-token window), more requests than
    slots: identical tokens, step log (oracle cycles included) and
    ``EngineStats``."""
    jeng, teng = _engines("float32", cache_len=56, max_slots=3, eos_id=-1,
                          temperature=0.0)
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_the_moe_archs_on_cpu(arch, capsys):
    from repro_torch.serve.__main__ import main as serve_main

    serve_main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--prompt-len", "20", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke  device=cpu" in out
    assert "simulated SoC:" in out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_prefill_through_kernel_matches_plain_on_card(arch, monkeypatch):
    """Prefill on the card with attention through the Hopper kernel
    (one launch per layer; mixtral's band narrower than the prompt,
    grok's softcap): in bf16 the kernel against its plain version on
    every layer's own operands (the tensor-core path, 2e-2); in fp32
    (the FMA path) the whole model's logits against the same prefill
    through the plain version (1e-4).  A whole-model bf16 comparison
    would not hold a kernel fault: the router's top-k turns the
    one-ulp differences of two attention implementations into
    different experts (on an H100, 3 and 8 of a layer's 822
    token-choices in grok's smoke config), as no dense model does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.kernels.swa import kernel as t_swa_kernel
    from repro_torch.kernels.swa import ops as t_swa_ops

    dev = torch.device("cuda")
    cfg = t_smoke(arch)
    params = param_values(t_models.init_params(0, cfg, device=dev))
    toks = torch.as_tensor(_tokens(cfg, (3, 137)), device=dev)
    kernel_op, operands = t_swa_ops.swa_attention, []

    def capture(*args, **kw):
        operands.append((args, kw))
        return kernel_op(*args, **kw)

    monkeypatch.setattr(t_swa_ops, "swa_attention", capture)
    before = t_swa_kernel.launches_by_path["tc"]
    t_models.prefill(params, {"tokens": toks}, cfg, 160)
    assert t_swa_kernel.launches_by_path["tc"] == before + cfg.num_layers
    for (q, k, v), kw in operands:
        assert q.dtype == torch.bfloat16
        _close(kernel_op(q, k, v, **kw).cpu(),
               t_swa_ops.swa_attention_plain(q, k, v, **kw).cpu(),
               MOE_TOL["bfloat16"])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    monkeypatch.setattr(t_swa_ops, "swa_attention", kernel_op)
    got, _, _ = t_models.prefill(params, {"tokens": toks}, cfg32, 160)
    monkeypatch.setattr(t_swa_ops, "swa_attention",
                        t_swa_ops.swa_attention_plain)
    want, _, _ = t_models.prefill(params, {"tokens": toks}, cfg32, 160)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), MODEL_TOL["float32"])

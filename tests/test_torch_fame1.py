"""The port's FAME-1 combinators against the reference: the same token
streams and stall schedules, made from a seed with numpy, through
``repro.core.fame1`` and ``repro_torch.core.fame1``.  Every comparison
is exact equality — target-visible states and outputs, token counts and
the scheduler's ``last_host_cycles``."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import fame1 as j_f1  # noqa: E402
from repro_torch.core import fame1 as t_f1  # noqa: E402

N_TOKENS = 12


def _accumulator(state, x):
    """y_t = state + x_t; state' = y_t (either package's arrays)."""
    y = state + x
    return y, y


def _t_mac(state, x):
    acc = torch.clamp(state["acc"] + x["a"] * x["b"], -1e6, 1e6)
    return {"acc": acc}, acc


def _j_mac(state, x):
    acc = jnp.clip(state["acc"] + x["a"] * x["b"], -1e6, 1e6)
    return {"acc": acc}, acc


def _pipelines():
    """accelerator -> memory-latency stage, as in the paper's Figure 2,
    in both packages."""
    t = t_f1.FAME1Pipeline([
        t_f1.Component("nvdla", lambda s, x: (s + 1, x * 2.0),
                       torch.tensor(0, dtype=torch.int32),
                       torch.tensor(0.0)),
        t_f1.Component("memmodel", lambda s, x: (s + x, x + s),
                       torch.tensor(0.0), torch.tensor(0.0))])
    j = j_f1.FAME1Pipeline([
        j_f1.Component("nvdla", lambda s, x: (s + 1, x * 2.0),
                       jnp.int32(0), jnp.float32(0.0)),
        j_f1.Component("memmodel", lambda s, x: (s + x, x + s),
                       jnp.float32(0.0), jnp.float32(0.0))])
    return t, j


def _assert_run_equal(t_out, j_out):
    (t_states, t_outs, t_n), (j_states, j_outs, j_n) = t_out, j_out
    assert int(t_n) == int(j_n)
    np.testing.assert_array_equal(t_outs.numpy(), np.asarray(j_outs))
    for a, b in zip(t_states, j_states):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@given(st.lists(st.integers(min_value=0, max_value=3), min_size=N_TOKENS,
                max_size=N_TOKENS))
@settings(max_examples=15, deadline=None, database=None)
def test_stall_invariance_accumulator(stall_runs):
    """stall_runs[i] stalled host cycles before token i: the port's
    hosted run equals its stall-free run and the reference's hosted run
    on the same schedule, state and every output."""
    valid = np.concatenate([[False] * r + [True] for r in stall_runs])
    tokens = np.arange(1.0, N_TOKENS + 1.0, dtype=np.float32)
    host_tokens = tokens[np.clip(np.cumsum(valid) - 1, 0, N_TOKENS - 1)]
    ref_state, ref_out, n0 = t_f1.run_hosted(
        _accumulator, torch.tensor(0.0), torch.from_numpy(tokens),
        np.ones(N_TOKENS, bool))
    state, out, n = t_f1.run_hosted(
        _accumulator, torch.tensor(0.0),
        torch.from_numpy(host_tokens), valid)
    j_state, j_out, j_n = j_f1.run_hosted(
        _accumulator, jnp.float32(0.0), jnp.asarray(host_tokens),
        jnp.asarray(valid))
    assert int(n0) == int(n) == int(j_n) == N_TOKENS
    assert float(ref_state) == float(state) == float(j_state)
    np.testing.assert_array_equal(ref_out[:N_TOKENS].numpy(),
                                  out[:N_TOKENS].numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))


@pytest.mark.parametrize("seed", range(6))
def test_stall_invariance_mac_random_schedules(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(N_TOKENS).astype(np.float32)
    b = rng.standard_normal(N_TOKENS).astype(np.float32)
    h = 3 * N_TOKENS
    valid = np.zeros(h, bool)
    valid[rng.permutation(h)[:N_TOKENS]] = True
    idx = np.clip(np.cumsum(valid) - 1, 0, N_TOKENS - 1)
    t_state, t_out, _ = t_f1.run_hosted(
        _t_mac, {"acc": torch.tensor(0.0)},
        {"a": torch.from_numpy(a[idx]), "b": torch.from_numpy(b[idx])},
        valid)
    free_state, free_out, _ = t_f1.run_hosted(
        _t_mac, {"acc": torch.tensor(0.0)},
        {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
        np.ones(N_TOKENS, bool))
    j_state, j_out, _ = j_f1.run_hosted(
        _j_mac, {"acc": jnp.float32(0.0)},
        {"a": jnp.asarray(a[idx]), "b": jnp.asarray(b[idx])},
        jnp.asarray(valid))
    assert float(t_state["acc"]) == float(free_state["acc"]) == \
        float(j_state["acc"])
    np.testing.assert_array_equal(t_out[:N_TOKENS].numpy(),
                                  free_out.numpy())
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))


@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=6, deadline=None, database=None)
def test_pipeline_stall_invariance(seed):
    """Back-pressured two-stage pipeline: the output stream under random
    per-component stalls equals the stall-free one and the reference's
    under the same stalls."""
    tokens = np.arange(1.0, 9.0, dtype=np.float32)
    t = tokens.shape[0]
    t_pipe, j_pipe = _pipelines()
    h = 8 * t
    ref = t_pipe.run(torch.from_numpy(tokens), np.zeros((h, 2), bool),
                     max_host_cycles=h)
    stalls = np.random.default_rng(seed).random((h * 3, 2)) < 0.4
    got = t_pipe.run(torch.from_numpy(tokens), torch.from_numpy(stalls),
                     max_host_cycles=h * 3)
    want = j_pipe.run(jnp.asarray(tokens), jnp.asarray(stalls),
                      max_host_cycles=h * 3)
    assert int(ref[2]) == int(got[2]) == t
    np.testing.assert_array_equal(ref[1].numpy(), got[1].numpy())
    _assert_run_equal(got, want)
    assert t_pipe.last_host_cycles == j_pipe.last_host_cycles


def test_fame1_wrap_gates_state():
    hosted = t_f1.fame1_wrap(_accumulator)
    s0 = torch.tensor(5.0)
    s1, (_, v) = hosted(s0, (torch.tensor(3.0), torch.tensor(False)))
    assert float(s1) == 5.0 and not bool(v)        # clock-gated
    s2, (_, v) = hosted(s0, (torch.tensor(3.0), torch.tensor(True)))
    assert float(s2) == 8.0 and bool(v)


# --------------------------------------------------------------------------
# chunked token bundles and the early-exit scheduler
# --------------------------------------------------------------------------
def _bundle_step(lib):
    """A counter that stops at 25 — the early-exit condition — gated by
    ``active`` as the FAME-1 contract demands."""
    where = torch.where if lib is torch else jnp.where

    def step(carry, x, active):
        total, n = carry
        go = active & (n < 25)
        total = where(go, total + x, total)
        n = where(go, n + 1, n)
        return (total, n), where(go, total, 0)
    return step


@pytest.mark.parametrize("chunk_len", [1, 4, 7, 16, 64])
def test_chunked_scan_invariant_to_chunk_len_and_equal_to_reference(
        chunk_len):
    """Bundle sizes that do and do not divide the 40-cycle stream give
    the same carry and per-cycle outputs, and the reference's shapes,
    values and bundle count."""
    xs = np.random.default_rng(3).integers(0, 100, 40).astype(np.int32)
    t_carry, t_ys, t_run = t_f1.chunked_scan(
        _bundle_step(torch),
        (torch.tensor(0, dtype=torch.int32),
         torch.tensor(0, dtype=torch.int32)),
        torch.from_numpy(xs), cont_fn=lambda c: c[1] < 25,
        chunk_len=chunk_len)
    j_carry, j_ys, j_run = j_f1.chunked_scan(
        _bundle_step(jnp), (jnp.int32(0), jnp.int32(0)), jnp.asarray(xs),
        cont_fn=lambda c: c[1] < 25, chunk_len=chunk_len)
    assert int(t_run) == int(j_run)
    assert [int(c) for c in t_carry] == [int(c) for c in j_carry]
    np.testing.assert_array_equal(t_ys.numpy(), np.asarray(j_ys))
    assert int(t_carry[0]) == int(xs[:25].sum())
    assert t_ys.shape[0] % chunk_len == 0
    np.testing.assert_array_equal(t_ys[:25].numpy(), np.cumsum(xs[:25]))
    with pytest.raises(ValueError, match="chunk_len"):
        t_f1.chunked_scan(_bundle_step(torch), (torch.tensor(0),) * 2,
                          torch.from_numpy(xs), cont_fn=lambda c: True,
                          chunk_len=0)


def test_early_exit_equals_fixed_schedule_no_stalls():
    tokens = np.arange(1.0, 33.0, dtype=np.float32)
    t_pipe, j_pipe = _pipelines()
    fixed = t_pipe.run(torch.from_numpy(tokens), early_exit=False)
    fixed_cycles = t_pipe.last_host_cycles
    fast = t_pipe.run(torch.from_numpy(tokens), early_exit=True)
    _assert_run_equal(fast, j_pipe.run(jnp.asarray(tokens)))
    assert t_pipe.last_host_cycles == j_pipe.last_host_cycles
    _assert_run_equal(fixed, j_pipe.run(jnp.asarray(tokens),
                                        early_exit=False))
    assert fixed_cycles == j_pipe.last_host_cycles == 4 * 32 * 3
    assert int(fast[2]) == 32
    np.testing.assert_array_equal(fixed[1].numpy(), fast[1].numpy())
    assert t_pipe.last_host_cycles < fixed_cycles / 3


@pytest.mark.parametrize("seed", range(6))
def test_early_exit_equals_fixed_under_random_stalls(seed):
    tokens = np.arange(1.0, 17.0, dtype=np.float32)
    stalls = np.random.default_rng(seed).random((16 * 8, 2)) < 0.45
    t_pipe, j_pipe = _pipelines()
    for early in (False, True):
        got = t_pipe.run(torch.from_numpy(tokens), host_stalls=stalls,
                         early_exit=early)
        want = j_pipe.run(jnp.asarray(tokens), host_stalls=stalls,
                          early_exit=early)
        _assert_run_equal(got, want)
        assert t_pipe.last_host_cycles == j_pipe.last_host_cycles
        if early:
            np.testing.assert_array_equal(got[1].numpy(), fixed[1].numpy())
        fixed = got


@pytest.mark.parametrize("chunk_cycles", [64, 5])
def test_all_stall_cycles_are_compacted_away(chunk_cycles):
    """Every other host cycle stalls every component: the early-exit
    path drops them first, and last_host_cycles is the reference's
    count for the same schedule."""
    tokens = np.arange(1.0, 9.0, dtype=np.float32)
    h = 8 * 8
    stalls = np.zeros((h, 2), bool)
    stalls[::2] = True
    stalls[1::4, 1] = True              # and some single-component stalls
    t_pipe, j_pipe = _pipelines()
    fixed = t_pipe.run(torch.from_numpy(tokens), host_stalls=stalls,
                       early_exit=False)
    fast = t_pipe.run(torch.from_numpy(tokens), host_stalls=stalls,
                      chunk_cycles=chunk_cycles)
    want = j_pipe.run(jnp.asarray(tokens), host_stalls=stalls,
                      chunk_cycles=chunk_cycles)
    _assert_run_equal(fast, want)
    assert t_pipe.last_host_cycles == j_pipe.last_host_cycles <= h // 2
    assert int(fixed[2]) == int(fast[2]) == 8
    np.testing.assert_array_equal(fixed[1].numpy(), fast[1].numpy())


def test_truncated_schedule_drains_what_the_reference_drains():
    """A schedule too short to drain every token: the same tokens come
    out, the rest of the sink buffer stays zero, and the component
    states are those after the fires the schedule allowed."""
    tokens = np.arange(1.0, 17.0, dtype=np.float32)
    stalls = np.random.default_rng(5).random((20, 2)) < 0.5
    t_pipe, j_pipe = _pipelines()
    for early in (False, True):
        got = t_pipe.run(torch.from_numpy(tokens), host_stalls=stalls,
                         early_exit=early)
        want = j_pipe.run(jnp.asarray(tokens), host_stalls=stalls,
                          early_exit=early)
        _assert_run_equal(got, want)
        assert 0 < int(got[2]) < 16
        assert t_pipe.last_host_cycles == j_pipe.last_host_cycles

"""The port's memory pipeline (paper Fig. 2) and the per-access LLC/DRAM
models against the reference: the same address traces and host-stall
schedules, made from a seed with numpy, through ``repro.core`` and
``repro_torch.core``.  Every comparison is exact equality — per-access
latencies, totals, host cycles, hit and row-hit rates."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import cache as j_cache  # noqa: E402
from repro.core import dram as j_dram  # noqa: E402
from repro.core import socsim as j_soc  # noqa: E402
from repro.core import traces as j_tr  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import socsim as t_soc  # noqa: E402
from repro_torch.core import traces as t_tr  # noqa: E402
from repro_torch.core.cache import LLCConfig  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402

CPU = "cpu"
LLC = LLCConfig(size_bytes=4096, ways=4, block_bytes=64)
J_LLC = j_cache.LLCConfig(size_bytes=4096, ways=4, block_bytes=64)
T = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace() -> np.ndarray:
    """Two interleaved sequential streams, NVDLA-style (bytes)."""
    a = np.arange(T // 2, dtype=np.int64) * 32
    b = (1 << 20) + np.arange(T // 2, dtype=np.int64) * 32
    return np.stack([a, b], axis=1).reshape(-1)


def _j_stream(addrs, llc=J_LLC, **kw):
    return j_soc.simulate_dbb_stream(jnp.asarray(addrs), llc=llc, **kw)


# --------------------------------------------------------------------------
# the FAME-1 LLC -> DRAM pipeline
# --------------------------------------------------------------------------
def test_pipeline_hits_match_exact_cache_sim():
    addrs = _trace()
    res = t_soc.simulate_dbb_stream(addrs, llc=LLC, device=CPU)
    hits = t_cache.simulate_trace(addrs // LLC.block_bytes, sets=LLC.sets,
                                  ways=LLC.ways, device=CPU)
    np.testing.assert_array_equal(res.latencies.numpy() == 20, hits)
    np.testing.assert_array_equal(res.latencies.numpy(),
                                  np.asarray(_j_stream(addrs).latencies))


def test_spatial_locality_latency():
    """Sequential 32 B bursts with 64 B blocks: alternating miss/hit."""
    lats = t_soc.simulate_dbb_stream(np.arange(32) * 32, llc=LLC,
                                     device=CPU).latencies.numpy()
    assert (lats[1::2] == 20).all() and (lats[0::2] > 20).all()


@given(st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=6, deadline=None, database=None)
def test_fame1_stall_invariance_full_pipeline(seed):
    """Per-access latencies and totals are identical under random host
    stalls, equal to the reference's under the same schedule, and the
    scheduler spends the reference's host cycles."""
    addrs = _trace()
    ref = t_soc.simulate_dbb_stream(addrs, llc=LLC, device=CPU)
    stalls = np.random.default_rng(seed).random((6 * T, 2)) < 0.35
    out = t_soc.simulate_dbb_stream(addrs, llc=LLC, host_stalls=stalls,
                                    device=CPU)
    want = _j_stream(addrs, host_stalls=jnp.asarray(stalls))
    np.testing.assert_array_equal(ref.latencies.numpy(),
                                  out.latencies.numpy())
    np.testing.assert_array_equal(out.latencies.numpy(),
                                  np.asarray(want.latencies))
    assert int(out.total_cycles) == int(want.total_cycles)
    assert out.host_cycles == want.host_cycles


@pytest.mark.parametrize("early_exit", [True, False])
def test_dbb_stream_matches_reference_on_a_layer_window(early_exit):
    """A 96-burst arbiter-interleaved window at the default LLC/DRAM and
    at a tiny cache: latencies and host cycles of both schedules."""
    addrs = t_tr.expand(t_tr.default_dbb_window(max_bursts=96))
    for llc in (LLCConfig(), LLC):
        got = t_soc.simulate_dbb_stream(addrs, llc=llc, early_exit=early_exit,
                                        device=CPU)
        want = _j_stream(addrs, llc=j_cache.LLCConfig(
            llc.size_bytes, llc.ways, llc.block_bytes), early_exit=early_exit)
        np.testing.assert_array_equal(got.latencies.numpy(),
                                      np.asarray(want.latencies))
        assert got.host_cycles == want.host_cycles


def _card_route(monkeypatch, calls):
    """The stream's card route on the CPU: the LLC walk's launch stood in
    for by ``tests/test_torch_llc.py``'s numpy emulation of
    ``llc_set_walk``, the plain walk and the generic replay refused."""
    from test_torch_llc import _no_plain, _set_walk_stand_in

    from repro_torch.kernels.llc import kernel as llc_k
    from repro_torch.kernels.llc import ops as llc_ops
    from repro_torch.kernels.llc import ref as llc_ref

    monkeypatch.setattr(t_soc, "_on_card", lambda x: True)
    monkeypatch.setattr(llc_ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(llc_ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(llc_k, "set_walk_kernel", _set_walk_stand_in(calls))
    monkeypatch.setattr(t_soc.FAME1Pipeline, "_replay", _no_plain)


def _wide_trace(rng, n: int) -> np.ndarray:
    """Bursts spread over the 40-bit address space: at one set, block //
    sets passes 2**31."""
    return (rng.integers(0, 1 << 35, n) * 32).astype(np.int64)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_route_is_the_reference_and_the_generic_pipeline(
        monkeypatch, seed, early_exit):
    """``simulate_dbb_stream``'s card route (one set walk, emulated; the
    DRAM by sort and compare) under seeded random stalls: latencies,
    total and host cycles equal to the reference's, and the final LLC
    and DRAM states (``_stream_on_card``) to the generic pipeline's."""
    from repro_torch.core.fame1 import FAME1Pipeline, plan_schedule

    rng = np.random.default_rng(seed)
    addrs = np.concatenate([_trace(), rng.integers(0, 1 << 14, 80) * 32])
    stalls = rng.random((3 * addrs.shape[0], 2)) < 0.35
    llc = LLC if seed != 2 else LLCConfig(size_bytes=2048, ways=2,
                                          block_bytes=32)
    want = _j_stream(addrs, llc=j_cache.LLCConfig(
        llc.size_bytes, llc.ways, llc.block_bytes),
        host_stalls=jnp.asarray(stalls), early_exit=early_exit)
    a = torch.as_tensor(addrs)
    pipe = FAME1Pipeline([t_soc.llc_component(llc, device=CPU),
                          t_soc.dram_component(llc, DRAMConfig(),
                                               device=CPU)])
    states, _, _ = pipe.run(a, host_stalls=stalls,
                            max_host_cycles=stalls.shape[0],
                            early_exit=early_exit)
    calls = []
    _card_route(monkeypatch, calls)
    got = t_soc.simulate_dbb_stream(addrs, llc=llc, host_stalls=stalls,
                                    early_exit=early_exit, device=CPU)
    assert calls == ["set_walk"]
    np.testing.assert_array_equal(got.latencies.numpy(),
                                  np.asarray(want.latencies))
    assert int(got.total_cycles) == int(want.total_cycles)
    assert got.host_cycles == want.host_cycles
    fires, drained, _ = plan_schedule(a.shape[0], 2, stalls, stalls.shape[0],
                                      early_exit=early_exit)
    (tags, age), open_rows = t_soc._stream_on_card(
        a, llc, DRAMConfig(), fires, drained)[0]
    (w_tags, w_age), w_rows = states
    for g, w in ((tags, w_tags), (age, w_age), (open_rows, w_rows)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("early_exit", [True, False])
def test_card_route_keeps_address_wide_tags(monkeypatch, early_exit):
    """At one set, tags (block // sets) pass 2**31: the card route walks
    them as dense indices and maps them back, equal to the port's plain
    replay (the reference runs int32 without x64)."""
    rng = np.random.default_rng(7)
    one_set = LLCConfig(size_bytes=4 * 64, ways=4, block_bytes=64)
    addrs = _wide_trace(rng, 96)
    addrs[1::3] = addrs[::3][:addrs[1::3].shape[0]]   # reuse: hits
    assert (addrs // 64).max() >= 2**31
    stalls = rng.random((300, 2)) < 0.35
    want = t_soc.simulate_dbb_stream(addrs, llc=one_set, host_stalls=stalls,
                                     early_exit=early_exit, device=CPU)
    assert (want.latencies.numpy() == 20).any()
    calls = []
    _card_route(monkeypatch, calls)
    got = t_soc.simulate_dbb_stream(addrs, llc=one_set, host_stalls=stalls,
                                    early_exit=early_exit, device=CPU)
    assert calls == ["set_walk"]
    assert torch.equal(got.latencies, want.latencies)
    assert got.host_cycles == want.host_cycles


@pytest.mark.parametrize("ways", [129, 256, 1024])
def test_card_route_runs_wide_llcs_as_one_walk(monkeypatch, ways):
    """Past 128 ways the stream's LLC is still one set walk on the card
    (the warp route; emulated), never a plain replay: its latencies and
    host cycles are the reference's under seeded stalls, on a stream
    that overflows the cache."""
    rng = np.random.default_rng(ways)
    wide = LLCConfig(size_bytes=64 * ways * 2, ways=ways, block_bytes=64)
    addrs = rng.integers(0, 3 * ways, 6 * ways) * 64
    stalls = rng.random((3 * addrs.shape[0], 2)) < 0.3
    want = _j_stream(addrs, llc=j_cache.LLCConfig(wide.size_bytes, ways, 64),
                     host_stalls=stalls)
    calls = []
    _card_route(monkeypatch, calls)
    got = t_soc.simulate_dbb_stream(addrs, llc=wide, host_stalls=stalls,
                                    device=CPU)
    assert calls == ["set_walk"]
    np.testing.assert_array_equal(got.latencies.numpy(),
                                  np.asarray(want.latencies))
    assert got.host_cycles == want.host_cycles
    assert (got.latencies.numpy() > 20).sum() > ways


def test_dram_row_locality_visible_through_pipeline():
    dram = DRAMConfig()
    tiny = LLCConfig(size_bytes=64, ways=1, block_bytes=64)
    lats = t_soc.simulate_dbb_stream(np.arange(T) * 64, llc=tiny, dram=dram,
                                     device=CPU).latencies.numpy()
    miss = lats[lats > 20]
    assert (miss == 20 + dram.t_cas_cycles).mean() > 0.8


@pytest.mark.parametrize("n", [96, 768])
def test_segment_totals_equal_stream_and_reference(n):
    segs = t_tr.default_dbb_window(max_bursts=n)
    j_segs = j_tr.default_dbb_window(max_bursts=n)
    for llc in (LLC, LLCConfig()):
        j_llc = j_cache.LLCConfig(llc.size_bytes, llc.ways, llc.block_bytes)
        got = t_soc.simulate_dbb_segments(segs, llc=llc, device=CPU)
        want = j_soc.simulate_dbb_segments(j_segs, llc=j_llc)
        assert _same_totals(got, want)
        stream = t_soc.simulate_dbb_stream(t_tr.expand(segs), llc=llc,
                                           device=CPU)
        assert got.total_cycles == int(stream.total_cycles)
        assert got.check_invariants(DRAMConfig()) is got


def _same_totals(a, b) -> bool:
    return (a.total_cycles, a.accesses, a.llc_hits, a.dram_row_hits) == \
        (b.total_cycles, b.accesses, b.llc_hits, b.dram_row_hits)


def test_configs_are_keyword_only():
    """The reference's positional-config shim is not carried over: a
    positional config is a TypeError, as is a missing llc."""
    segs = t_tr.default_dbb_window(max_bursts=32)
    addrs = t_tr.expand(segs)
    with pytest.raises(TypeError):
        t_soc.simulate_dbb_stream(addrs, LLC, device=CPU)
    with pytest.raises(TypeError):
        t_soc.simulate_dbb_segments(segs, LLC, DRAMConfig(), device=CPU)
    with pytest.raises(TypeError):
        t_soc.simulate_dbb_segments(segs, device=CPU)
    with pytest.raises(ValueError, match="row_bytes"):
        t_soc.simulate_dbb_segments(
            segs, llc=LLCConfig(4096, 4, 64),
            dram=DRAMConfig(row_bytes=96), device=CPU)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    segs = t_tr.default_dbb_window(max_bursts=32)
    for call in (
            lambda: t_soc.simulate_dbb_stream(t_tr.expand(segs), llc=LLC),
            lambda: t_soc.simulate_dbb_segments(segs, llc=LLC),
            lambda: t_dram.access_latencies([0], banks=4, row_bytes=64,
                                            t_cas=1, t_rcd=1, t_rp=1),
            lambda: t_dram.row_hit_rate([0], DRAMConfig()),
            lambda: t_cache.hit_rate([0, 1], LLC),
            lambda: t_cache.sequential_burst_trace(4, 32, 64)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# --------------------------------------------------------------------------
# closed-form invariants
# --------------------------------------------------------------------------
def _good(dram=DRAMConfig()):
    acc, hits, row = 100, 60, 25
    misses = acc - hits
    total = (acc * 20 + misses * dram.t_cas_cycles
             + (misses - row) * (dram.t_rp_cycles + dram.t_rcd_cycles))
    return dict(accesses=acc, llc_hits=hits, dram_row_hits=row,
                total_cycles=total)


@pytest.mark.parametrize("bad, match", [
    (dict(total_cycles=1), "closed form"),
    (dict(llc_hits=101), "exceeds accesses"),
    (dict(dram_row_hits=41), "exceeds LLC misses"),
    (dict(accesses=-1), "negative"),
    (dict(llc_hits=60.0), "must be ints"),
])
def test_check_segment_totals_errors_match_reference(bad, match):
    args = {**_good(), **bad}
    with pytest.raises(t_soc.PipelineInvariantError, match=match) as t_err:
        t_soc.check_segment_totals(dram=DRAMConfig(), **args)
    with pytest.raises(j_soc.PipelineInvariantError) as j_err:
        j_soc.check_segment_totals(dram=j_dram.DRAMConfig(), **args)
    assert str(t_err.value) == str(j_err.value)
    assert issubclass(t_soc.PipelineInvariantError, ValueError)
    t_soc.check_segment_totals(dram=DRAMConfig(), **_good())


def test_check_segment_totals_batch_names_every_bad_point():
    good = _good()
    cols = {k: [good[k]] * 4 for k in good}
    cols["total_cycles"][1] += 1
    cols["llc_hits"][3] = 101
    drams = [DRAMConfig()] * 4
    with pytest.raises(t_soc.PipelineInvariantError) as t_err:
        t_soc.check_segment_totals_batch(drams=drams, **cols)
    with pytest.raises(j_soc.PipelineInvariantError) as j_err:
        j_soc.check_segment_totals_batch(drams=[j_dram.DRAMConfig()] * 4,
                                         **cols)
    assert str(t_err.value) == str(j_err.value)
    assert "2/4" in str(t_err.value) and "[1]" in str(t_err.value) \
        and "[3]" in str(t_err.value)
    with pytest.raises(t_soc.PipelineInvariantError, match="lengths"):
        t_soc.check_segment_totals_batch(drams=drams[:3], **cols)
    t_soc.check_segment_totals_batch(
        drams=drams, **{k: [good[k]] * 4 for k in good})


# --------------------------------------------------------------------------
# per-access DRAM and LLC models
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_access_latencies_and_row_hit_rate_match_reference(seed):
    rng = np.random.default_rng(seed)
    # a few hot rows across banks, so hits, conflicts and cold banks mix
    addrs = rng.integers(0, 40, 300) * 1024 + rng.integers(0, 1024, 300)
    for cfg in (DRAMConfig(), DRAMConfig(banks=4, row_bytes=1024,
                                         t_cas_cycles=11, t_rcd_cycles=9,
                                         t_rp_cycles=7)):
        kw = dict(banks=cfg.banks, row_bytes=cfg.row_bytes,
                  t_cas=cfg.t_cas_cycles, t_rcd=cfg.t_rcd_cycles,
                  t_rp=cfg.t_rp_cycles)
        got = t_dram.access_latencies(addrs, device=CPU, **kw)
        want = j_dram.access_latencies(jnp.asarray(addrs), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        j_cfg = j_dram.DRAMConfig(**{
            f: getattr(cfg, f) for f in ("banks", "row_bytes", "t_cas_cycles",
                                         "t_rcd_cycles", "t_rp_cycles")})
        assert t_dram.row_hit_rate(addrs, cfg, device=CPU) == \
            j_dram.row_hit_rate(addrs, j_cfg)


@pytest.mark.parametrize("sets, ways, block", [(1, 2, 64), (4, 3, 32),
                                               (16, 4, 64)])
def test_hit_rate_and_sequential_burst_trace_match_reference(sets, ways,
                                                             block):
    cfg = LLCConfig(sets * ways * block, ways, block)
    j_cfg = j_cache.LLCConfig(cfg.size_bytes, ways, block)
    for n, burst, base in ((100, 32, 0), (64, 64, 4096), (37, 16, 96)):
        got = t_cache.sequential_burst_trace(n, burst, block, base,
                                             device=CPU)
        want = j_cache.sequential_burst_trace(n, burst, block, base)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert t_cache.hit_rate(got.numpy(), cfg, device=CPU) == \
            j_cache.hit_rate(want, j_cfg)
    trace = np.random.default_rng(sets).integers(0, 3 * sets * ways, 200)
    assert t_cache.hit_rate(trace, cfg, device=CPU) == \
        j_cache.hit_rate(trace, j_cfg)

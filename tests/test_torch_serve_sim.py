"""The simulator pieces of the port's serving slice against the
reference, bit for bit, on the CPU: the segment LLC engine
(``core.cache.simulate_segments``: hits, per-segment hits, miss runs,
final state, warm continuation), the closed-form DRAM row model
(``core.dram.segment_row_hits`` with ``open_rows``) and the interference
and step lanes (``core.sweep.step_lane_metrics``, cold and after a warm
prefix, with co-runners)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cache as j_cache  # noqa: E402
from repro.core import dram as j_dram  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import traces as j_traces  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import dram as t_dram  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core import traces as t_traces  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_segments(rng, n):
    """Stride runs of every kind the engine dispatches: burst strides
    below, at and above the block size, empty segments, overlaps."""
    return [(int(rng.integers(0, 1 << 14)) * 32,
             int(rng.choice([8, 16, 32, 64, 96, 128])),
             int(rng.integers(0, 160))) for _ in range(n)]


def _long_segments(llc):
    """A cold sweep of 3x the cache (the reference's closed form), its
    warm repeat (round-scanned prefix + closed-form suffix) and a stray
    revisit."""
    big = llc.size_bytes * 3 // 32
    return [(0, 32, big), (0, 32, big), (7 * 64, 64, 300),
            (1 << 20, 32, 40)]


def _sim_pair(segs, llc, state=None):
    want = j_cache.simulate_segments(segs, j_cache.LLCConfig(
        **dataclasses.asdict(llc)), state, per_segment=True,
        collect_miss_runs=True)
    got = t_cache.simulate_segments(
        segs, llc, None if state is None else
        tuple(np.asarray(s) for s in state), per_segment=True,
        collect_miss_runs=True, device="cpu")
    return got, want


def _assert_same_sim(got, want):
    assert (got.hits, got.accesses) == (want.hits, want.accesses)
    np.testing.assert_array_equal(got.per_segment_hits,
                                  want.per_segment_hits)
    assert got.miss_runs == want.miss_runs
    for g, w in zip(got.state, want.state):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


LLCS = [t_cache.LLCConfig(4096, 4, 64), t_cache.LLCConfig(2048, 2, 32),
        t_cache.LLCConfig(8192, 8, 128)]


@pytest.mark.parametrize("seed,llc", enumerate(LLCS),
                         ids=lambda c: f"{c.sets}x{c.ways}x{c.block_bytes}"
                         if isinstance(c, t_cache.LLCConfig) else str(c))
def test_simulate_segments_bit_identical_cold_and_warm(seed, llc):
    rng = np.random.default_rng(seed)
    got, want = _sim_pair(_random_segments(rng, 40), llc)
    _assert_same_sim(got, want)
    more = _random_segments(rng, 20)
    got2, want2 = _sim_pair(more, llc, want.state)
    _assert_same_sim(got2, want2)
    # continuing from the port's own (tensor) state is the same replay
    _assert_same_sim(t_cache.simulate_segments(
        more, llc, got.state, per_segment=True, collect_miss_runs=True,
        device="cpu"), want2)


@pytest.mark.parametrize("llc", LLCS, ids=lambda c: f"{c.sets}x{c.ways}x"
                         f"{c.block_bytes}")
def test_simulate_segments_long_segments_and_split_runs(llc):
    got, want = _sim_pair(_long_segments(llc), llc)
    assert want.closed_form_segments >= 2     # the split path ran
    _assert_same_sim(got, want)
    assert t_cache.hit_rate_segments(_long_segments(llc), llc,
                                     device="cpu") == want.hit_rate


def test_simulate_segments_dbb_window_and_rejects_bad_stride():
    llc = t_cache.LLCConfig(64 * 1024, 8, 64)
    win = t_traces.default_dbb_window(max_bursts=2048)
    assert [t_traces.segment_tuple(s) for s in win] == \
        [j_traces.segment_tuple(s)
         for s in j_traces.default_dbb_window(max_bursts=2048)]
    _assert_same_sim(*_sim_pair(win, llc))
    with pytest.raises(ValueError, match="stride must be positive"):
        t_cache.simulate_segments([(0, 0, 4)], llc, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_row_hits_bit_identical_with_open_rows(seed):
    rng = np.random.default_rng(seed)
    cfg = t_dram.DRAMConfig()
    jcfg = j_dram.DRAMConfig()
    segs = [(int(rng.integers(0, 1 << 16)) * 32,
             int(rng.choice([32, 64, 2048, 4096])),
             int(rng.integers(0, 300))) for _ in range(40)]
    got = t_dram.segment_row_hits(segs, cfg)
    want = j_dram.segment_row_hits(segs, jcfg)
    more = segs[::-1]
    got2 = t_dram.segment_row_hits(more, cfg, open_rows=got.open_rows)
    want2 = j_dram.segment_row_hits(more, jcfg, open_rows=want.open_rows)
    for g, w in ((got, want), (got2, want2)):
        assert (g.row_hits, g.accesses) == (w.row_hits, w.accesses)
        np.testing.assert_array_equal(g.open_rows, w.open_rows)
        np.testing.assert_array_equal(g.per_segment, w.per_segment)


@pytest.mark.parametrize("corunners,wss", [(0, "l1"), (2, "llc"),
                                           (1, "dram")])
def test_step_lane_metrics_cold_and_warm_prefix(corunners, wss):
    llc = t_cache.LLCConfig(8 * 1024, 4, 64)
    win = t_traces.default_dbb_window(max_bursts=1024)
    kw = dict(llc=llc, dram=t_dram.DRAMConfig(),
              mix=t_sweep.MixConfig(corunners, wss), chunk_bursts=16)
    jkw = dict(llc=j_cache.LLCConfig(8 * 1024, 4, 64),
               dram=j_dram.DRAMConfig(),
               mix=j_sweep.MixConfig(corunners, wss), chunk_bursts=16)
    jwin = j_traces.default_dbb_window(max_bursts=1024)
    for prefix, jprefix in ((None, None), (win, jwin), (win[:5], jwin[:5])):
        got = t_sweep.step_lane_metrics(win, warm_prefix=prefix,
                                        device="cpu", **kw)
        want = j_sweep.step_lane_metrics(jwin, warm_prefix=jprefix, **jkw)
        assert got.to_record() == want.to_record()
        assert t_sweep.LaneMetrics.from_record(got.to_record()) == got


def test_way_mask_lanes_wait_for_their_slice():
    with pytest.raises(NotImplementedError, match="way_mask"):
        t_sweep.interference_lane_metrics(
            t_traces.default_dbb_window(max_bursts=64),
            llc=t_cache.LLCConfig(4096, 4, 64), dram=t_dram.DRAMConfig(),
            mix=t_sweep.MixConfig(), way_mask=0b11, device="cpu")

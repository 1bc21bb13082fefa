"""The port's LLC simulator against the reference: the per-access
true-LRU oracle and the segment-lane engine, bit for bit, from small
random traces up to the whole YOLOv3 frame."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import accelerator as j_acc  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.core import runtime as j_rt  # noqa: E402
from repro.core import soc as j_soc  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import traces as j_tr  # noqa: E402
from repro_torch.core import accelerator as t_acc  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import runtime as t_rt  # noqa: E402
from repro_torch.core import soc as t_soc  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core import traces as t_tr  # noqa: E402
from repro_torch.core.cache import LLCConfig  # noqa: E402
from repro_torch.kernels.llc import kernel as llc_k  # noqa: E402
from repro_torch.kernels.llc import ops as llc_ops  # noqa: E402
from repro_torch.kernels.llc import ref as llc_ref  # noqa: E402
from test_torch_llc import (_card_route, _lane_scan_stand_in,  # noqa: E402
                            _no_plain)

CPU = "cpu"

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run many small ops, which intra-op threads
    only slow down — and parallel test workers would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FIG5_SIZES = (0.5, 64, 1024, 4096)
FIG5_BLOCKS = (32, 64, 128)
# mixed geometries: set counts 1..64 split over several lane buckets
MIXED = [LLCConfig(512, 8, 64), LLCConfig(1024, 2, 32),
         LLCConfig(2048, 4, 64), LLCConfig(4096, 4, 64),
         LLCConfig(8192, 2, 128), LLCConfig(4096, 1, 64)]


def _jllc(c):
    return j_cache.LLCConfig(c.size_bytes, c.ways, c.block_bytes)


def _oracle_counts(segs, c):
    """Per-segment hits from expanding the trace through the port's
    per-access oracle."""
    blocks = t_tr.expand([t_tr.Segment(*s) for s in segs]) // c.block_bytes
    bits = t_cache.simulate_trace(blocks, sets=c.sets, ways=c.ways,
                                  device=CPU)
    out, o = [], 0
    for s in segs:
        out.append(int(bits[o:o + s[2]].sum()))
        o += s[2]
    return out


# --------------------------------------------------------------------------
# per-access oracle
# --------------------------------------------------------------------------
@settings(max_examples=30, deadline=None, database=None)
@given(sets=st.sampled_from([1, 2, 4]), ways=st.sampled_from([1, 2, 3]),
       trace=st.lists(st.integers(0, 11), min_size=48, max_size=48))
def test_simulate_trace_matches_reference(sets, ways, trace):
    """Small address ranges make repeated hits, evictions and age ties
    (equal-age ways after a cold start) common."""
    j = np.asarray(j_cache.simulate_trace(
        jnp.asarray(trace, jnp.int32), sets=sets, ways=ways))
    t = t_cache.simulate_trace(trace, sets=sets, ways=ways, device=CPU)
    np.testing.assert_array_equal(t, j)


def test_simulate_trace_lru_order():
    assert t_cache.simulate_trace([0, 1, 0], sets=1, ways=2,
                                  device=CPU).tolist() == \
        [False, False, True]
    assert t_cache.simulate_trace([0, 1, 0, 2, 0, 1], sets=1, ways=2,
                                  device=CPU).tolist() == \
        [False, False, True, False, True, False]


def test_simulate_trace_runs_on_cuda_by_default():
    """``simulate_trace`` is an entry point of the port: with no device
    it runs on ``cuda``, so without a card it raises rather than run the
    host loop."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cache.simulate_trace([0, 1, 0], sets=1, ways=2)


def test_simulate_trace_tags_are_int32():
    """Tags (block // sets) that leave int32 raise on either route, as
    the reference casts them to int32."""
    for blocks in ([0, 2**31 * 4], [-(2**31) * 4 - 4, 0]):
        with pytest.raises(OverflowError, match="int32"):
            t_cache.simulate_trace(blocks, sets=4, ways=2, device=CPU)
    assert t_cache.simulate_trace([2**31 * 4 - 1], sets=4, ways=2,
                                  device=CPU).tolist() == [False]


@settings(max_examples=16, deadline=None, database=None)
@given(sets=st.sampled_from([1, 2, 4]),
       ways=st.sampled_from([1, 3, 8, 129, 160, 256, 1024]),
       seed=st.integers(0, 2**32 - 1))
def test_simulate_trace_card_route_is_one_walk_and_the_reference(
        sets, ways, seed):
    """On the card route ``simulate_trace`` is one set walk (no
    per-access host loop): every access an arrival of count 1 from a
    cold state, its hits the plain loop's and the reference's jitted
    scan's, on traces past the capacity (victims chosen) and at way
    counts past the thread routes' 128."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 3 * sets * ways // 2 + 2, 2 * sets * ways + 8)
    want = t_cache.simulate_trace(blocks, sets=sets, ways=ways, device=CPU)
    ref = np.asarray(j_cache.simulate_trace(jnp.asarray(blocks, jnp.int32),
                                            sets=sets, ways=ways))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _card_route(mp, calls)
        got = t_cache.simulate_trace(blocks, sets=sets, ways=ways,
                                     device=CPU)
    assert calls == ["set_walk"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    assert 0 < want.sum() < want.shape[0]


@pytest.mark.parametrize("ways", [129, 160, 256, 1024])
def test_wide_lane_engine_is_the_reference(monkeypatch, ways):
    """The lane engine (``segment_lane_hit_counts``) at way counts past
    128, on the card route (the warp route's emulation standing in for
    the launch) and on the CPU, against the reference's, on a window
    that overflows every geometry."""
    segs = [t_tr.segment_tuple(s) for s in
            t_tr.default_dbb_window(max_bursts=4096, chunk_bursts=16)[:48]]
    segs = [(b % (1 << 18), s_, c) for b, s_, c in segs] * 2
    cfgs = [LLCConfig(ways * 64, ways, 64), LLCConfig(ways * 64 * 4, ways, 32)]
    want = np.asarray(j_sweep.segment_lane_hit_counts(
        segs, [_jllc(c) for c in cfgs]))
    got_cpu = t_sweep.segment_lane_hit_counts(segs, cfgs, device=CPU)
    calls = []
    monkeypatch.setattr(llc_ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(llc_ref, "lane_scan_ref", _no_plain)
    monkeypatch.setattr(llc_k, "lane_scan_kernel", _lane_scan_stand_in(calls))
    got = t_sweep.segment_lane_hit_counts(segs, cfgs, device=CPU)
    assert calls == ["lane_scan warp"]
    np.testing.assert_array_equal(got_cpu, want)
    np.testing.assert_array_equal(got, want)
    assert (want.sum(axis=1) < sum(c for _, _, c in segs)).all()


def test_cold_state_layout():
    tags, age = t_cache.cold_state(4, 2, device=CPU)
    assert tags.shape == age.shape == (4, 2)
    assert tags.dtype == age.dtype == torch.int32
    assert (tags == -1).all() and (age == 0).all()


# --------------------------------------------------------------------------
# segment-lane engine
# --------------------------------------------------------------------------
def _random_segments(rng, n, span_bursts=400, max_count=300):
    """Stride-8/16/32 segments over a small region, so later segments
    revisit (warm, partial overlaps) and some are cold."""
    segs = []
    for _ in range(n):
        stride = int(rng.choice([8, 16, 32, 32, 32]))
        base = int(rng.integers(0, span_bursts)) * 32
        if rng.random() < 0.15:
            base += 1 << 20            # a far, cold region
        segs.append((base, stride, int(rng.integers(0, max_count))))
    return segs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_lanes_bit_identical_to_reference_and_oracle(seed):
    segs = _random_segments(np.random.default_rng(seed), 40)
    t = t_sweep.segment_lane_hit_counts(segs, MIXED, device=CPU)
    j = j_sweep.segment_lane_hit_counts(segs, [_jllc(c) for c in MIXED])
    np.testing.assert_array_equal(t, j)
    for i, c in enumerate(MIXED):
        assert t[i].tolist() == _oracle_counts(segs, c), c
    assert len(t_sweep.lane_buckets(MIXED)) > 1


def test_segment_lanes_long_warm_segments_take_the_suffix():
    """Segments far longer than ways*sets blocks: round scan, then the
    closed-form suffix, on warm and cold state alike."""
    segs = [(0, 32, 3000), (0, 32, 500), (1 << 18, 32, 64),
            (32 * 100, 32, 2500), (1 << 19, 16, 900)]
    t = t_sweep.segment_lane_hit_counts(segs, MIXED, device=CPU)
    j = j_sweep.segment_lane_hit_counts(segs, [_jllc(c) for c in MIXED])
    np.testing.assert_array_equal(t, j)
    for i, c in enumerate(MIXED):
        assert t[i].tolist() == _oracle_counts(segs, c), c


def test_segment_lanes_per_lane_traces():
    rng = np.random.default_rng(7)
    llc = LLCConfig(2048, 4, 64)
    lanes = [_random_segments(rng, n) for n in (12, 20, 5)]
    t = t_sweep.segment_lane_hit_counts(lanes, [llc] * 3, device=CPU)
    j = j_sweep.segment_lane_hit_counts(lanes, [_jllc(llc)] * 3)
    np.testing.assert_array_equal(t, j)
    for i, segs in enumerate(lanes):
        assert t[i, :len(segs)].tolist() == _oracle_counts(segs, llc)
    rates = t_sweep.segment_lane_hit_rates(lanes, [llc] * 3, device=CPU)
    np.testing.assert_array_equal(
        rates, j_sweep.segment_lane_hit_rates(lanes, [_jllc(llc)] * 3))


def test_segment_lanes_reject_unsupported_traces():
    with pytest.raises(ValueError, match="stride"):
        t_sweep.segment_lane_hit_counts([(0, 256, 100)],
                                        [LLCConfig(4096, 4, 64)], device=CPU)
    with pytest.raises(OverflowError, match="int32"):
        t_sweep.segment_lane_hit_counts([((1 << 31) - 64, 32, 4)],
                                        [LLCConfig(4096, 4, 64)], device=CPU)
    with pytest.raises(ValueError, match="lane traces"):
        t_sweep.segment_lane_hit_counts([[(0, 32, 4)]] * 2,
                                        [LLCConfig(4096, 4, 64)], device=CPU)


def test_lane_buckets_and_grid_configs_equal():
    t_cfgs = t_sweep.grid_configs(FIG5_SIZES, FIG5_BLOCKS)
    j_cfgs = j_sweep.grid_configs(FIG5_SIZES, FIG5_BLOCKS)
    assert {k: (c.size_bytes, c.ways, c.block_bytes)
            for k, c in t_cfgs.items()} == \
        {k: (c.size_bytes, c.ways, c.block_bytes) for k, c in j_cfgs.items()}
    assert t_sweep.lane_buckets(list(t_cfgs.values())) == \
        j_sweep.lane_buckets(list(j_cfgs.values()))


# --------------------------------------------------------------------------
# the sim-driven accelerator model
# --------------------------------------------------------------------------
def test_op_stream_hit_rates_grid_matches_on_prefix():
    llcs = [LLCConfig(64 * 1024, 4, 64), LLCConfig(256 * 1024, 8, 64),
            LLCConfig(128 * 1024, 2, 32)]
    t = t_acc.op_stream_hit_rates_grid(t_rt.compile_network(), llcs,
                                       max_ops=6, device=CPU)
    j = j_acc.op_stream_hit_rates_grid(j_rt.compile_network(),
                                       [_jllc(c) for c in llcs], max_ops=6)
    assert t == j
    for llc, rates in zip(llcs, t):
        point = t_acc.op_stream_hit_rates(
            t_rt.compile_network(), t_acc.MemSystemConfig(llc=llc),
            max_ops=6, device=CPU)
        j_point = j_acc.op_stream_hit_rates(
            j_rt.compile_network(), j_acc.MemSystemConfig(llc=_jllc(llc)),
            max_ops=6)
        assert rates == point == j_point


def test_simulated_whole_frame_exact():
    t = t_soc.run_yolov3(mode="simulated", device=CPU)
    j = j_soc.run_yolov3(mode="simulated")
    assert t.accel_s == j.accel_s
    assert t.accel_s * 1e3 == 65.13808718588858
    assert t.detail["accel"]["per_layer"] == j.detail["accel"]["per_layer"]


def test_simulated_llc_sweep_exact():
    t = t_soc.llc_sweep(sizes_kib=FIG5_SIZES, blocks=FIG5_BLOCKS,
                        mode="simulated", device=CPU)
    j = j_soc.llc_sweep(sizes_kib=FIG5_SIZES, blocks=FIG5_BLOCKS,
                        mode="simulated")
    assert t == j


def test_whole_frame_per_segment_hits_exact():
    segs = t_tr.network_trace()
    cfg = LLCConfig()
    t = t_sweep.segment_lane_hit_counts(segs, [cfg], device=CPU)
    j = j_sweep.segment_lane_hit_counts(j_tr.network_trace(), [_jllc(cfg)])
    np.testing.assert_array_equal(t, j)
    assert t.shape == (1, 328)


def _chip_smoke():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("part", ["trace", "engines", "mask", "farm"])
def test_chip_smoke_wide_anchors_are_the_references(part):
    """``chip_smoke.py``'s ``wide_path`` anchors are the reference's,
    recomputed here by the recipe beside them (all but the lane engine's
    (3, 1024) counts, ~1 min of the reference on this CPU), and the
    port's CPU route gives them too."""
    from repro.core import dram as j_dram
    from repro.core import farm as j_farm
    from repro.core import socsim as j_socsim
    from repro.utils.stats import latency_summary as j_summary

    cs = _chip_smoke()
    if part == "trace":
        seed, span, n = cs.WIDE_TRACE
        blocks = np.random.default_rng(seed).integers(0, span, n)
        for (sets, ways), want in cs.WIDE_TRACE_ANCHORS.items():
            hits = np.asarray(j_cache.simulate_trace(
                jnp.asarray(blocks, jnp.int32), sets=sets, ways=ways))
            assert (int(hits.sum()), cs.packed_sha(hits)) == want
    elif part == "engines":
        window = [j_tr.segment_tuple(x) for x in j_tr.default_dbb_window(
            max_bursts=cs.WIDE_WINDOW[0], chunk_bursts=cs.WIDE_WINDOW[1])]
        window += window[::-1]
        addrs = j_tr.expand([j_tr.Segment(*x) for x in window])
        for spec, want in cs.WIDE_LLC_ANCHORS.items():
            cfg = j_cache.LLCConfig(*spec)
            stream = j_socsim.simulate_dbb_stream(jnp.asarray(addrs), llc=cfg)
            got = (int(j_cache.simulate_segments(window, cfg).hits),
                   j_cache.hit_rate(addrs // cfg.block_bytes, cfg),
                   int(stream.total_cycles),
                   cs.array_sha(stream.latencies, np.int32))
            assert got == want, spec
            port = t_cache.simulate_segments(window, LLCConfig(*spec),
                                             device=CPU)
            assert port.hits == want[0]
    elif part == "mask":
        mc = LLCConfig(*cs.WIDE_MASK_LLC)
        bursts, chunk, passes = cs.WIDE_MASK_WINDOW
        b, s_, c, nv = t_sweep.corunner_meta(
            [t_tr.segment_tuple(x) for x in t_tr.default_dbb_window(
                max_bursts=bursts, chunk_bursts=chunk)] * passes, llc=mc,
            mix=t_sweep.MixConfig(2, "llc"))
        sels = np.where(nv, cs.WIDE_MASK[0], cs.WIDE_MASK[1])
        nb = np.where(c > 0, (b + (c - 1) * s_) // mc.block_bytes
                      - b // mc.block_bytes + 1, 0)
        r_needed = -(-nb // mc.sets)
        kw = dict(max_sets=mc.sets, max_ways=mc.ways,
                  r_pad=int(r_needed.max()), suffix="none")
        ref = np.asarray(j_cache.segment_lane_scan(
            *(jnp.asarray(a, jnp.int32) for a in (b, s_, c, r_needed)),
            np.zeros(b.shape[0], bool), mc.sets, mc.ways, mc.block_bytes,
            sels, **kw))
        assert (int(ref.sum()), cs.array_sha(ref, np.int64)) == \
            cs.WIDE_MASK_ANCHOR
        port = t_cache.segment_lane_scan(
            b[None], s_[None], c[None], r_needed, np.zeros(b.shape[0], bool),
            [mc.sets], [mc.ways], [mc.block_bytes], sels[None], **kw,
            device=CPU)[0]
        np.testing.assert_array_equal(port, ref)
    else:
        for nodes, want in cs.WIDE_FARM_ANCHORS.items():
            res = j_farm.simulate_farm(
                llc=j_cache.LLCConfig(cs.FARM_LLC_BYTES, 8, 64),
                dram=j_dram.DRAMConfig(), farm=j_farm.FarmConfig(nodes=nodes),
                max_bursts=cs.FARM_BURSTS)
            assert {**j_summary(res.steady()),
                    "noc_mean": float(res.noc_latency.mean()),
                    "mem_mean": float(res.mem_latency.mean()),
                    "host_steps": res.noc.host_steps} == want, nodes

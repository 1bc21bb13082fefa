"""The port's interference and partition lanes, per-request latencies
and figure sweeps against the reference: the same segment streams and
plans, made from a seed with numpy, through ``repro.core`` and
``repro_torch.core``.  Every comparison is exact equality — per-segment
hits, miss bits and final state of the lane engine, ``LaneMetrics`` and
``SweepGrid`` records, per-chunk latencies."""
from __future__ import annotations

import functools
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cache as j_cache  # noqa: E402
from repro.core import dram as j_dram  # noqa: E402
from repro.core import socsim as j_soc  # noqa: E402
from repro.core import sweep as j_sweep  # noqa: E402
from repro.core import traces as j_tr  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core import traces as t_tr  # noqa: E402
from repro_torch.core.cache import LLCConfig  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.core.sweep import MixConfig  # noqa: E402
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
LLC = LLCConfig(size_bytes=16 * 1024, ways=4, block_bytes=64)  # 64 sets
LLC_64K = LLCConfig(size_bytes=64 * 1024, ways=8, block_bytes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jllc(c):
    return j_cache.LLCConfig(c.size_bytes, c.ways, c.block_bytes)


def _jdram(d):
    return j_dram.DRAMConfig(banks=d.banks, row_bytes=d.row_bytes,
                             t_cas_cycles=d.t_cas_cycles,
                             t_rcd_cycles=d.t_rcd_cycles,
                             t_rp_cycles=d.t_rp_cycles)


def _jmix(m):
    return j_sweep.MixConfig(m.corunners, m.wss)


def _window(n):
    return t_tr.default_dbb_window(max_bursts=n), \
        j_tr.default_dbb_window(max_bursts=n)


# --------------------------------------------------------------------------
# the lane engine: way_sels x collect x suffix x return_state
# --------------------------------------------------------------------------
GEOMS = [LLCConfig(2048, 4, 64), LLCConfig(4096, 2, 32),
         LLCConfig(1024, 8, 64), LLCConfig(8192, 4, 128)]


def _lane_inputs(seed, *, long: bool, masked: bool):
    """Per-lane segment streams over a small region (revisits, partial
    overlaps, far cold segments), per-lane plans and allocation masks
    (zero = the unpartitioned sentinel)."""
    rng = np.random.default_rng(seed)
    n_lane, n_seg = len(GEOMS), 14
    base = rng.integers(0, 96, (n_lane, n_seg)) * 32
    base[rng.random((n_lane, n_seg)) < 0.2] += 1 << 20
    stride = rng.choice([16, 32], (n_lane, n_seg))
    # short: at most 13 blocks, inside every geometry's ways * sets
    top = 700 if long else 25
    count = rng.integers(0, top, (n_lane, n_seg))
    sets = np.array([c.sets for c in GEOMS])
    ways = np.array([c.ways for c in GEOMS])
    bb = np.array([c.block_bytes for c in GEOMS])
    wsel = np.zeros((n_lane, n_seg), np.int64)
    if masked:
        full = (1 << ways[:, None]) - 1
        wsel = rng.integers(0, 256, (n_lane, n_seg)) & full
        wsel[rng.random((n_lane, n_seg)) < 0.3] = 0
    r_needed = np.zeros((n_lane, n_seg), np.int64)
    cold = np.zeros((n_lane, n_seg), bool)
    for l, c in enumerate(GEOMS):
        r, cd = t_sweep._lane_plan(
            list(zip(base[l].tolist(), stride[l].tolist(),
                     count[l].tolist())), [c])
        last = base[l] + np.maximum(count[l] - 1, 0) * stride[l]
        nb = np.where(count[l] > 0, last // bb[l] - base[l] // bb[l] + 1, 0)
        r_needed[l] = np.where(wsel[l] != 0, -(-nb // sets[l]), r)
        cold[l] = cd
    return base, stride, count, r_needed, cold, sets, ways, bb, wsel


def _both_engines(args, masked, **kw):
    base, stride, count, r_needed, cold, sets, ways, bb, wsel = args
    ms, mw = int(sets.max()), int(ways.max())
    r_pad = max(1, int(r_needed.max()))
    sel = wsel if masked else None
    got = t_cache.segment_lane_scan(base, stride, count, r_needed, cold,
                                    sets, ways, bb, sel, max_sets=ms,
                                    max_ways=mw, r_pad=r_pad, device=CPU,
                                    **kw)
    fn = functools.partial(j_cache.segment_lane_scan, max_sets=ms,
                           max_ways=mw, r_pad=r_pad, **kw)
    j_args = [jnp.asarray(a, jnp.int32) for a in
              (base, stride, count, r_needed)] + [jnp.asarray(cold)] + \
        [jnp.asarray(a, jnp.int32) for a in (sets, ways, bb)]
    if masked:
        j_args.append(jnp.asarray(wsel, jnp.int32))
    want = jax.jit(jax.vmap(fn))(*j_args)
    return got, want


def _flat(out):
    """(hits[, miss][, (tags, ts)]) -> list of numpy arrays."""
    out = out if isinstance(out, tuple) else (out,)
    flat = []
    for o in out:
        flat.extend(o if isinstance(o, tuple) else (o,))
    return [np.asarray(a) for a in flat]


@pytest.mark.parametrize("suffix", ["full", "one", "none"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("collect, return_state", [(False, False),
                                                   (True, True)])
def test_segment_lane_scan_matches_reference(suffix, masked, collect,
                                             return_state):
    """Four geometries in one batch (2 to 64 sets, 2 to 8 ways), long
    warm and cold segments, masked and sentinel segments: per-segment
    hits, miss bits and final (tags, ts) equal the reference's vmapped
    engine under every static specialization."""
    args = _lane_inputs(11, long=True, masked=masked)
    got, want = _both_engines(args, masked, collect=collect, suffix=suffix,
                              return_state=return_state)
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want) == 1 + collect + 2 * return_state
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_suffix_specializations_agree_where_the_plan_allows(masked):
    """Short segments planned warm (no suffix anywhere: every segment
    retires in its rounds): 'none', 'one' and 'full' give the same
    hits, miss bits and state."""
    args = list(_lane_inputs(5, long=False, masked=masked))
    base, stride, count, _, _, sets, ways, bb, _ = args
    last = base + np.maximum(count - 1, 0) * stride
    nb = np.where(count > 0, last // bb[:, None] - base // bb[:, None] + 1, 0)
    assert (nb <= (ways * sets)[:, None]).all()
    args[3] = -(-nb // sets[:, None])
    args[4] = np.zeros_like(args[4])                 # no cold segments
    runs = {s: _flat(t_cache.segment_lane_scan(
        *args[:8], args[8] if masked else None,
        max_sets=64, max_ways=8, r_pad=int(args[3].max()), collect=True,
        suffix=s, return_state=True, device=CPU))
        for s in ("full", "one", "none")}
    for s in ("one", "none"):
        for a, b in zip(runs[s], runs["full"]):
            np.testing.assert_array_equal(a, b)


def test_segment_lane_scan_rejects_unknown_suffix():
    with pytest.raises(ValueError, match="suffix"):
        t_cache.segment_lane_scan([[0]], [[32]], [[4]], [[1]], [[False]],
                                  [4], [2], [64], max_sets=4, max_ways=2,
                                  r_pad=1, suffix="two", device=CPU)


# --------------------------------------------------------------------------
# way partitioning: isolation and the sentinel identity (twins of
# tests/test_waymask.py)
# --------------------------------------------------------------------------
VICTIM_REGION = 0x1000_0000
CORUN_REGION = 0x2000_0000


def _two_class_lane(rng, n_segs: int = 24):
    b, s, c, is_victim = [], [], [], []
    for i in range(n_segs):
        victim = i % 2 == 0
        region = VICTIM_REGION if victim else CORUN_REGION
        b.append(region + int(rng.integers(0, 64)) * 64 * 64)
        s.append(int(rng.choice((32, 64))))
        c.append(int(rng.integers(32, 256)))
        is_victim.append(victim)
    return (np.asarray(b, np.int64), np.asarray(s, np.int64),
            np.asarray(c, np.int64), np.asarray(is_victim, bool))


def test_masked_ways_never_hold_foreign_lines_and_match_reference():
    rng = np.random.default_rng(7)
    for trial in range(5):
        b, s, c, nv = _two_class_lane(rng)
        vm = int(rng.choice((0b0001, 0b0011, 0b0110)))
        sels = t_sweep.partition_way_sels(nv, LLC, vm)
        hits, runs, (tags, ts) = t_sweep._masked_lane_run(
            b, s, c, LLC, sels, return_state=True, device=CPU)
        j_hits, j_runs, (j_tags, j_ts) = j_sweep._masked_lane_run(
            b, s, c, _jllc(LLC), sels, return_state=True)
        np.testing.assert_array_equal(hits, j_hits)
        np.testing.assert_array_equal(tags, j_tags)
        np.testing.assert_array_equal(ts, j_ts)
        for g, w in zip(runs, j_runs):
            np.testing.assert_array_equal(g, w)
        w, st_ = np.nonzero(tags != -1)
        addr = (tags[w, st_].astype(np.int64) * LLC.sets + st_) * 64
        co = ((1 << LLC.ways) - 1) & ~vm
        for way, victim_line in zip(w, addr < CORUN_REGION):
            mask = vm if victim_line else co
            assert (mask >> way) & 1, f"trial {trial}: way {way}"


def test_partition_protects_victim_reuse():
    (segs, j_segs) = _window(512)
    segs, j_segs = segs * 2, j_segs * 2
    mix, dram = MixConfig(2, "llc"), DRAMConfig()
    base = t_sweep.interference_lane_metrics(segs, llc=LLC_64K, dram=dram,
                                             mix=mix, device=CPU)
    part = t_sweep.interference_lane_metrics(segs, llc=LLC_64K, dram=dram,
                                             mix=mix, way_mask=0x0F,
                                             device=CPU)
    assert part.nvdla_hit_rate > base.nvdla_hit_rate
    assert part.total_cycles < base.total_cycles
    assert part.to_record() == j_sweep.interference_lane_metrics(
        j_segs, llc=_jllc(LLC_64K), dram=_jdram(dram), mix=_jmix(mix),
        way_mask=0x0F).to_record()


def test_full_mask_is_bit_exact_unpartitioned():
    segs, _ = _window(512)
    full = (1 << LLC_64K.ways) - 1
    for n in (0, 2):
        mix = MixConfig(n, "llc" if n else "l1")
        a = t_sweep.interference_lane_metrics(segs, llc=LLC_64K,
                                              dram=DRAMConfig(), mix=mix,
                                              device=CPU)
        b = t_sweep.interference_lane_metrics(segs, llc=LLC_64K,
                                              dram=DRAMConfig(), mix=mix,
                                              way_mask=full, device=CPU)
        assert a == b


def test_partition_way_sels():
    with pytest.raises(ValueError, match="at least one way"):
        t_sweep.partition_way_sels(np.array([True]), LLC, 0x10)
    full = (1 << LLC.ways) - 1
    assert t_sweep.partition_way_sels(np.array([True, False]), LLC,
                                      full).tolist() == [full, full]
    assert t_sweep.partition_way_sels(np.array([True, False]), LLC,
                                      0b0011).tolist() == [0b0011, 0b1100]


# --------------------------------------------------------------------------
# batched lanes, sequential lanes and the reference
# --------------------------------------------------------------------------
def test_corunner_meta_matches_segments_and_reference():
    nv, j_nv = _window(256)
    for size in (512, 2048, 65536):
        for mix in (MixConfig(0, "l1"), MixConfig(1, "llc"),
                    MixConfig(3, "llc"), MixConfig(2, "dram")):
            for chunk in (4, 16, 33):
                llc = LLCConfig(size, 2, 64)
                segs, nv_ref = t_sweep.corunner_segments(
                    nv, llc=llc, mix=mix, chunk_bursts=chunk)
                ref = np.asarray([t_tr.segment_tuple(s) for s in segs],
                                 np.int64).reshape(-1, 3)
                got = t_sweep.corunner_meta(nv, llc=llc, mix=mix,
                                            chunk_bursts=chunk)
                want = j_sweep.corunner_meta(j_nv, llc=_jllc(llc),
                                             mix=_jmix(mix),
                                             chunk_bursts=chunk)
                for k in range(3):
                    np.testing.assert_array_equal(got[k], ref[:, k])
                np.testing.assert_array_equal(got[3], nv_ref)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
    chunks = t_sweep.nvdla_chunks(nv, 16)
    for g, w in zip(chunks, j_sweep.nvdla_chunks(j_nv, 16)):
        np.testing.assert_array_equal(g, w)


def test_batch_equals_sequential_equals_reference():
    """Two set-count buckets, mixed geometries, mixes and DRAM specs,
    with masked and unmasked lanes side by side."""
    nv, j_nv = _window(512)
    llcs, drams, mixes, masks = [], [], [], []
    for w in (2, 4, 8):
        for mix, mask in ((MixConfig(0, "l1"), None),
                          (MixConfig(2, "llc"), None),
                          (MixConfig(2, "llc"), 0b1),
                          (MixConfig(3, "dram"), (1 << w) - 1)):
            llcs.append(LLCConfig(64 * 64 * w, w, 64))
            drams.append(DRAMConfig())
            mixes.append(mix)
            masks.append(mask)
    llcs.append(LLCConfig(256 * 64 * 2, 2, 64))
    drams.append(DRAMConfig(banks=16, row_bytes=1024))
    mixes.append(MixConfig(1, "llc"))
    masks.append(0b10)
    batch = t_sweep.interference_lane_metrics_batch(
        nv, llcs=llcs, drams=drams, mixes=mixes, way_masks=masks,
        device=CPU)
    j_batch = j_sweep.interference_lane_metrics_batch(
        j_nv, llcs=[_jllc(c) for c in llcs], drams=[_jdram(d) for d in drams],
        mixes=[_jmix(m) for m in mixes], way_masks=masks)
    unmasked = t_sweep.interference_lane_metrics_batch(
        nv, llcs=llcs, drams=drams, mixes=mixes, device=CPU)
    for i, (llc, dram, mix, mask) in enumerate(zip(llcs, drams, mixes,
                                                   masks)):
        seq = t_sweep.interference_lane_metrics(
            nv, llc=llc, dram=dram, mix=mix, way_mask=mask, device=CPU)
        assert batch[i] == seq, f"lane {i}"
        assert batch[i].to_record() == j_batch[i].to_record(), f"lane {i}"
        if mask is None:
            assert unmasked[i] == seq
    assert len(t_sweep.lane_buckets(llcs)) > 1


def test_batch_empty_length_and_mesh_checks():
    nv, _ = _window(64)
    assert t_sweep.interference_lane_metrics_batch(
        nv, llcs=[], drams=[], mixes=[], device=CPU) == []
    with pytest.raises(ValueError, match="lengths"):
        t_sweep.interference_lane_metrics_batch(
            nv, llcs=[LLC], drams=[DRAMConfig()] * 2, mixes=[MixConfig()],
            device=CPU)
    with pytest.raises(ValueError, match="way_masks"):
        t_sweep.interference_lane_metrics_batch(
            nv, llcs=[LLC], drams=[DRAMConfig()], mixes=[MixConfig()],
            way_masks=[None, 1], device=CPU)
    mesh = make_sweep_mesh([CPU] * 2)
    assert t_sweep.interference_lane_metrics_batch(
        nv, llcs=[], drams=[], mixes=[], mesh=mesh) == []
    with pytest.raises(ValueError, match="way-masked"):
        t_sweep.interference_lane_metrics_batch(
            nv, llcs=[LLC], drams=[DRAMConfig()], mixes=[MixConfig()],
            way_masks=[0x0F], mesh=mesh)
    with pytest.raises(ValueError, match="stride"):
        t_sweep.interference_lane_metrics_batch(
            nv, llcs=[LLCConfig(4096, 4, 16)], drams=[DRAMConfig()],
            mixes=[MixConfig()], device=CPU)


@pytest.mark.parametrize("mask", [None, 0x0F])
def test_lane_request_latencies_match_reference(mask):
    nv, j_nv = _window(512)
    mix = MixConfig(2, "llc")
    lat, metrics = t_sweep.lane_request_latencies(
        nv, llc=LLC_64K, dram=DRAMConfig(), mix=mix, way_mask=mask,
        device=CPU)
    j_lat, j_metrics = j_sweep.lane_request_latencies(
        j_nv, llc=_jllc(LLC_64K), dram=j_dram.DRAMConfig(), mix=_jmix(mix),
        way_mask=mask)
    np.testing.assert_array_equal(lat, j_lat)
    assert metrics.to_record() == j_metrics.to_record()
    assert metrics == t_sweep.interference_lane_metrics(
        nv, llc=LLC_64K, dram=DRAMConfig(), mix=mix, way_mask=mask,
        device=CPU)
    assert lat.shape[0] == 512 // 16
    assert 0 < int(lat.sum()) <= metrics.total_cycles
    # the solo lane's victim chunks are all of it
    solo, m0 = t_sweep.lane_request_latencies(
        nv, llc=LLC_64K, dram=DRAMConfig(), mix=MixConfig(), way_mask=mask,
        device=CPU)
    assert int(solo.sum()) == m0.total_cycles


# --------------------------------------------------------------------------
# the figure sweeps and their typed records
# --------------------------------------------------------------------------
def test_sweep_llc_records_equal_reference():
    for kw in (dict(sizes_kib=(0.5, 8, 1024), blocks=(32, 128),
                    window_bursts=512),
               dict(sizes_kib=(8,), blocks=(64,), window_bursts=None)):
        got = t_sweep.sweep_llc(device=CPU, **kw)
        want = j_sweep.sweep_llc(**kw)
        assert got.to_record() == want.to_record()
        assert t_sweep.SweepGrid.from_record(
            json.loads(json.dumps(got.to_record()))) == got
    assert got.window_bursts == t_tr.total_bursts(t_tr.network_trace())


def test_sweep_interference_records_equal_reference():
    got = t_sweep.sweep_interference(corunners=(0, 2, 4), window_bursts=512,
                                     device=CPU)
    want = j_sweep.sweep_interference(corunners=(0, 2, 4),
                                      window_bursts=512)
    assert got.to_record() == want.to_record()
    back = t_sweep.SweepGrid.from_record(json.loads(json.dumps(
        got.to_record())))
    assert back == got
    rh = got.sim_row_hit_rates
    assert rh[("l1", 4)] == rh[("l1", 0)] and rh[("dram", 4)] < rh[("dram", 0)]
    with pytest.raises(NotImplementedError, match="compaction"):
        t_sweep.sweep_interference(window_bursts=None, device=CPU)


# --------------------------------------------------------------------------
# the per-access oracles
# --------------------------------------------------------------------------
def test_per_access_oracles_match_reference_and_lanes():
    segs, j_segs = _window(256)
    addrs = t_tr.expand(segs)
    configs = [LLC, LLCConfig(512, 8, 64), LLCConfig(2048, 2, 32)]
    j_configs = [_jllc(c) for c in configs]
    with pytest.warns(DeprecationWarning, match="expanded-trace"):
        bits = t_sweep.batched_hits(addrs, configs, device=CPU)
    with pytest.warns(DeprecationWarning):
        j_bits = np.asarray(j_sweep.batched_hits(addrs, j_configs))
    np.testing.assert_array_equal(bits, j_bits)
    lanes = t_sweep.segment_lane_hit_counts(segs, configs, device=CPU)
    np.testing.assert_array_equal(bits.sum(axis=1), lanes.sum(axis=1))
    with pytest.warns(DeprecationWarning):
        rates = t_sweep.batched_hit_rates(addrs, configs, device=CPU)
    with pytest.warns(DeprecationWarning):
        np.testing.assert_array_equal(
            rates, np.asarray(j_sweep.batched_hit_rates(addrs, j_configs)))
    per_trace = np.stack([addrs, addrs[::-1].copy(), addrs + 4096])
    with pytest.warns(DeprecationWarning):
        got = t_sweep.batched_hits_per_trace(per_trace, configs, device=CPU)
    with pytest.warns(DeprecationWarning):
        want = np.asarray(j_sweep.batched_hits_per_trace(per_trace,
                                                         j_configs))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_sweep.segment_sweep_hit_rates(segs, configs, device=CPU),
        j_sweep.segment_sweep_hit_rates(j_segs, j_configs))
    np.testing.assert_array_equal(
        t_sweep.segment_sweep_hit_rates(segs, configs, device=CPU),
        t_sweep.segment_lane_hit_rates(segs, configs, device=CPU))


def test_padded_lanes_card_route_is_the_reference(monkeypatch):
    """On a CUDA device ``_simulate_padded`` runs one ``llc_set_walk``
    launch a distinct way count (emulated here by
    ``tests/test_torch_llc.py``'s numpy copy of the kernel) over each
    group's lanes laid end to end: ``batched_hits``, ``batched_hit_rates``
    and ``batched_hits_per_trace`` on lanes of mixed ways and sets equal
    the reference's, with their warnings."""
    from test_torch_llc import _no_plain, _set_walk_stand_in

    from repro_torch.kernels.llc import kernel as llc_k
    from repro_torch.kernels.llc import ops as llc_ops
    from repro_torch.kernels.llc import ref as llc_ref

    segs, _ = _window(256)
    addrs = t_tr.expand(segs)
    configs = [LLC, LLCConfig(512, 8, 64), LLCConfig(2048, 2, 32),
               LLCConfig(4096, 4, 128), LLCConfig(192, 3, 64),
               LLCConfig(64 * 8, 8, 64)]
    j_configs = [_jllc(c) for c in configs]
    per_trace = np.stack([addrs, addrs[::-1].copy(), addrs + 4096,
                          addrs // 2, addrs + 64, addrs[::-1] + 8192])
    with pytest.warns(DeprecationWarning):
        want = (np.asarray(j_sweep.batched_hits(addrs, j_configs)),
                np.asarray(j_sweep.batched_hit_rates(addrs, j_configs)),
                np.asarray(j_sweep.batched_hits_per_trace(per_trace,
                                                          j_configs)))
    calls = []
    monkeypatch.setattr(t_sweep, "_on_card", lambda x: True)
    monkeypatch.setattr(llc_ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(llc_ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(llc_k, "set_walk_kernel", _set_walk_stand_in(calls))
    with pytest.warns(DeprecationWarning, match="expanded-trace"):
        got = (t_sweep.batched_hits(addrs, configs, device=CPU),
               t_sweep.batched_hit_rates(addrs, configs, device=CPU),
               t_sweep.batched_hits_per_trace(per_trace, configs,
                                              device=CPU))
    n_ways = len({c.ways for c in configs})
    assert calls == ["set_walk"] * (3 * n_ways)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["batched_hits", "batched_hit_rates",
                                  "batched_hits_per_trace"])
def test_padded_lanes_card_route_runs_wide_ways(monkeypatch, name):
    """On the card the padded lanes walk by ``llc_set_walk`` at any way
    count: a 256-way lane beside a narrow one is one more walk (the warp
    route; emulated), no plain loop, and equals the CPU loop."""
    from test_torch_llc import _no_plain, _set_walk_stand_in

    from repro_torch.kernels.llc import kernel as llc_k
    from repro_torch.kernels.llc import ops as llc_ops
    from repro_torch.kernels.llc import ref as llc_ref

    ways = 256
    configs = [LLC, LLCConfig(64 * ways, ways, 64)]
    addrs = t_tr.expand(_window(64)[0])
    arg = np.stack([addrs, addrs]) if name == "batched_hits_per_trace" \
        else addrs
    with pytest.warns(DeprecationWarning):
        want = getattr(t_sweep, name)(arg, configs, device=CPU)
    calls = []
    monkeypatch.setattr(t_sweep, "_on_card", lambda x: True)
    monkeypatch.setattr(llc_ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(llc_ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(llc_k, "set_walk_kernel", _set_walk_stand_in(calls))
    with pytest.warns(DeprecationWarning):
        got = getattr(t_sweep, name)(arg, configs, device=CPU)
    assert calls == ["set_walk"] * 2
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["batched_hits", "batched_hit_rates",
                                  "batched_hits_per_trace"])
def test_deprecated_oracles_warn_at_the_callers_line(name):
    addrs = t_tr.expand(_window(64)[0])
    arg = addrs[None, :] if name == "batched_hits_per_trace" else addrs
    with pytest.warns(DeprecationWarning) as rec:
        getattr(t_sweep, name)(arg, [LLC], device=CPU)
    assert [w.filename for w in rec] == [__file__]


# --------------------------------------------------------------------------
# chip_smoke.py's simulator anchors come from the reference
# --------------------------------------------------------------------------
def test_chip_smoke_sim_anchors_are_the_references():
    """The recipe beside the anchors, run on the reference: Fig. 6, the
    24 lanes, one lane's latencies and the stalled pipeline (the Fig. 5
    full-frame record is pinned by the card run against the same
    reference; its windowed twin is tested above)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert j_sweep.sweep_interference().to_record() == cs.SIM_FIG6_RECORD
    llc = j_cache.LLCConfig(cs.SIM_LLC_BYTES, 8, 64)
    window = j_tr.default_dbb_window(max_bursts=4096) * 2
    recs = [m.to_record() for m in j_sweep.interference_lane_metrics_batch(
        window, llcs=[llc] * len(cs.SIM_LANES),
        drams=[j_dram.DRAMConfig()] * len(cs.SIM_LANES),
        mixes=[j_sweep.MixConfig(n, w) for w, n, _ in cs.SIM_LANES],
        way_masks=[m for *_, m in cs.SIM_LANES])]
    assert cs.sha256_json(recs) == cs.SIM_LANES_SHA256
    lat, m = j_sweep.lane_request_latencies(
        window, llc=llc, dram=j_dram.DRAMConfig(),
        mix=j_sweep.MixConfig(2, "llc"), way_mask=0x0F)
    assert {"n": int(lat.shape[0]), "sum": int(lat.sum()),
            "total": m.total_cycles,
            "sha256": cs.sha256_json(lat.tolist())} == cs.SIM_LATENCIES
    addrs = j_tr.expand(j_tr.default_dbb_window(max_bursts=4096))
    res = j_soc.simulate_dbb_stream(
        jnp.asarray(addrs), llc=j_cache.LLCConfig(),
        dram=j_dram.DRAMConfig(),
        host_stalls=jnp.asarray(cs.sim_stalls(addrs.shape[0])))
    assert {"t": int(res.latencies.shape[0]),
            "total": int(res.total_cycles), "host_cycles": res.host_cycles,
            "sha256": cs.sha256_json(np.asarray(res.latencies).tolist())
            } == cs.SIM_STREAM


def test_sweep_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nv, _ = _window(64)
    lane = dict(llc=LLC, dram=DRAMConfig(), mix=MixConfig(1, "llc"))
    for call in (
            lambda: t_sweep.sweep_llc(sizes_kib=(8,), blocks=(64,),
                                      window_bursts=64),
            lambda: t_sweep.sweep_interference(corunners=(0,),
                                               window_bursts=64),
            lambda: t_sweep.interference_lane_metrics(nv, way_mask=1,
                                                      **lane),
            lambda: t_sweep.lane_request_latencies(nv, way_mask=1, **lane),
            lambda: t_sweep.interference_lane_metrics_batch(
                nv, llcs=[LLC], drams=[DRAMConfig()],
                mixes=[MixConfig()]),
            lambda: t_sweep.batched_hits(t_tr.expand(nv), [LLC]),
            lambda: t_sweep.segment_sweep_hit_rates(nv, [LLC])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""The port's cycle-token NoC switch and SoC farm against the reference.

Every test of tests/test_noc.py, on the port and held to the reference
package on the same schedules: the token-bundle switch
(``NoCSwitch.simulate``, FIFO state in torch tensors) equals the
per-cycle scheduler (``simulate_reference``, the port's copy and the
reference's) array for array for every bundle size, including bundles
that do not divide the horizon, with the reference's ``host_steps``;
``chunked_scan`` leaves at a bundle boundary; the farm's victim tail
has the Fig. 6 QoS shape, its solo lane is ``interference_lane_metrics``
and its records are the reference's; and the Fig. 6 tail suite's smoke
run (nodes 0, 1, 2; 512 bursts; 64 KiB LLC; mask 0x0F) gives the
reference's summaries.  Every comparison is exact."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import farm as j_farm  # noqa: E402
from repro.core import noc as j_noc  # noqa: E402
from repro.core.cache import LLCConfig as JLLC  # noqa: E402
from repro.core.dram import DRAMConfig as JDRAM  # noqa: E402
from repro_torch.core.cache import LLCConfig  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.core.fame1 import chunked_scan  # noqa: E402
from repro_torch.core.farm import (  # noqa: E402
    FarmConfig,
    farm_schedule,
    simulate_farm,
    victim_window,
)
from repro_torch.core.noc import (  # noqa: E402
    NoCConfig,
    NoCOverflowError,
    NoCSwitch,
    simulate_reference,
)
from repro_torch.core.sweep import (  # noqa: E402
    MixConfig,
    interference_lane_metrics,
)
from repro_torch.utils.stats import latency_summary  # noqa: E402

GEOMETRIES = ((3, 40, 0), (4, 33, 2))        # (ports, T, link_latency)
BUNDLES = (1, 7, 64)                          # 7 divides nothing here
CPU = "cpu"
FIELDS = ("deliver_cycle", "egress", "src", "latency")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_schedule(rng, ports: int, cycles: int) -> np.ndarray:
    """Each port injects ~60% of cycles toward a random egress."""
    dests = rng.integers(-2, ports, size=(cycles, ports))
    return np.where(dests >= 0, dests, -1)


def _assert_same(a, b, ctx: str) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{ctx}: {f} diverged")


def _switch(ports, link, depth=None):
    return NoCSwitch(NoCConfig(ports=ports, link_latency=link,
                               queue_depth=depth), device=CPU)


# --------------------------------------------------------------------------
# the switch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ports,cycles,link", GEOMETRIES)
def test_bundles_match_reference(ports, cycles, link):
    """Three random schedules per geometry: the port's per-cycle
    scheduler is the reference's, and the token-bundle switch at
    bundles 1, 7 and 64 equals it with the reference switch's host
    steps and cycles run."""
    rng = np.random.default_rng(ports * 100 + cycles)
    jcfg = j_noc.NoCConfig(ports=ports, link_latency=link,
                           queue_depth=cycles)
    for trial in range(3):
        sched = _random_schedule(rng, ports, cycles)
        ref = j_noc.simulate_reference(sched, jcfg)
        mine = simulate_reference(sched, NoCConfig(ports=ports,
                                                   link_latency=link,
                                                   queue_depth=cycles))
        _assert_same(mine, ref, f"reference trial={trial}")
        assert mine.cycles_run == ref.cycles_run
        assert ref.deliver_cycle.shape[0] == int((sched >= 0).sum())
        for bundle in BUNDLES:
            got = _switch(ports, link, cycles).simulate(
                sched, bundle_cycles=bundle)
            want = j_noc.NoCSwitch(jcfg).simulate(sched,
                                                  bundle_cycles=bundle)
            ctx = f"ports={ports} link={link} trial={trial} bundle={bundle}"
            _assert_same(got, ref, ctx)
            assert (got.host_steps, got.cycles_run) == \
                (want.host_steps, want.cycles_run), ctx


def test_farm_schedule_parity_nondividing_bundle():
    farm = FarmConfig(nodes=2)
    sched = farm_schedule(40, farm)
    np.testing.assert_array_equal(
        sched, j_farm.farm_schedule(40, j_farm.FarmConfig(nodes=2)))
    cfg = NoCConfig(ports=4, link_latency=farm.link_latency)
    ref = j_noc.simulate_reference(sched, j_noc.NoCConfig(
        ports=4, link_latency=farm.link_latency))
    for bundle in (5, 13):
        got = NoCSwitch(cfg, device=CPU).simulate(sched,
                                                  bundle_cycles=bundle)
        _assert_same(got, ref, f"farm bundle={bundle}")
        assert got.host_steps < ref.cycles_run   # batching happened


def test_source_latencies_in_fifo_order():
    sched = np.full((12, 3), -1)
    sched[::2, 0] = 2     # victim every other cycle
    sched[:, 1] = 2       # co-runner every cycle, same egress
    res = _switch(3, 1, 16).simulate(sched)
    want = j_noc.NoCSwitch(j_noc.NoCConfig(
        ports=3, link_latency=1, queue_depth=16)).simulate(sched)
    lat = res.source_latencies(0)
    assert lat.shape[0] == 6
    assert np.all(lat >= 1)
    np.testing.assert_array_equal(lat, want.source_latencies(0))
    np.testing.assert_array_equal(res.inject_cycle, want.inject_cycle)


def test_overflow_raises_in_both_implementations():
    # two saturating sources, one egress, depth 1: the loser of
    # round-robin accumulates a backlog its FIFO cannot hold
    cfg = NoCConfig(ports=2, link_latency=0, queue_depth=1)
    sched = np.full((8, 2), 1)
    with pytest.raises(NoCOverflowError):
        simulate_reference(sched, cfg)
    with pytest.raises(NoCOverflowError):
        NoCSwitch(cfg, device=CPU).simulate(sched)
    with pytest.raises(j_noc.NoCOverflowError):
        j_noc.NoCSwitch(j_noc.NoCConfig(ports=2, link_latency=0,
                                        queue_depth=1)).simulate(sched)


def test_schedule_validation():
    cfg = NoCConfig(ports=2)
    for bad in (np.full((4, 3), -1), np.full((4, 2), 2)):
        with pytest.raises(ValueError):
            simulate_reference(bad, cfg)          # wrong width / egress
        with pytest.raises(ValueError):
            NoCSwitch(cfg, device=CPU).simulate(bad)
    for bad in (dict(ports=0), dict(link_latency=-1), dict(queue_depth=0)):
        with pytest.raises(ValueError):
            NoCConfig(**bad)


# --------------------------------------------------------------------------
# fame1.chunked_scan: bundle-size invariance of the host batching
# --------------------------------------------------------------------------
def _step(carry, x, active):
    i, acc = carry
    return (i + active.to(i.dtype), acc + torch.where(active, x, 0)), acc + x


def _zero():
    return (torch.tensor(0), torch.tensor(0))


def test_chunked_scan_invariant_to_chunk_len():
    xs = torch.arange(13)
    ref = None
    for chunk in (1, 3, 8, 64):
        carry, ys, bundles = chunked_scan(
            _step, _zero(), xs, cont_fn=lambda c: torch.tensor(True),
            chunk_len=chunk)
        got = (int(carry[0]), int(carry[1]), ys[:13].tolist())
        if ref is None:
            ref = got
            assert ref[0] == 13 and ref[1] == int(np.arange(13).sum())
        assert got == ref, f"chunk_len={chunk} diverged"


def test_chunked_scan_early_exit_stops_on_bundle_boundary():
    xs = torch.ones(20, dtype=torch.int64)
    carry, ys, bundles = chunked_scan(_step, _zero(), xs,
                                      cont_fn=lambda c: c[0] < 7,
                                      chunk_len=3)
    # bundles run until the predicate fails at a bundle boundary
    assert bundles == 3 and int(carry[0]) == 9
    # entries past the executed bundles hold zeros
    assert ys[9:].eq(0).all() and ys.shape[0] == 24


# --------------------------------------------------------------------------
# the farm
# --------------------------------------------------------------------------
LLC_SMOKE = dict(size_bytes=64 * 1024, ways=8, block_bytes=64)


def _p99(steady):
    s = np.sort(steady)
    return s[min(s.shape[0] - 1, int(np.ceil(s.shape[0] * 0.99)) - 1)]


def test_qos_shape_and_solo_identity():
    llc, dram = LLCConfig(**LLC_SMOKE), DRAMConfig()
    p99 = {}
    for n, mask in ((0, None), (2, None), (2, 0x0F)):
        res = simulate_farm(llc=llc, dram=dram,
                            farm=FarmConfig(nodes=n, way_mask=mask),
                            max_bursts=512, device=CPU)
        want = j_farm.simulate_farm(
            llc=JLLC(**LLC_SMOKE), dram=JDRAM(),
            farm=j_farm.FarmConfig(nodes=n, way_mask=mask), max_bursts=512)
        for f in ("noc_latency", "mem_latency", "total_latency"):
            np.testing.assert_array_equal(getattr(res, f), getattr(want, f))
        _assert_same(res.noc, want.noc, f"farm n={n} mask={mask}")
        assert res.metrics.to_record() == want.metrics.to_record()
        assert (res.requests, res.passes, res.noc.host_steps) == \
            (want.requests, want.passes, want.noc.host_steps)
        np.testing.assert_array_equal(res.steady(), want.steady())
        p99[(n, mask)] = _p99(res.steady())
        np.testing.assert_array_equal(
            res.total_latency, res.noc_latency + res.mem_latency)
        if n == 0:
            ref = interference_lane_metrics(
                victim_window("nvdla", max_bursts=512) * 2,
                llc=llc, dram=dram, mix=MixConfig(0, "l1"), device=CPU)
            assert res.metrics == ref
    assert p99[(2, None)] > p99[(0, None)]
    assert p99[(2, 0x0F)] < p99[(2, None)]


def test_npu_victim_backend():
    res = simulate_farm(llc=LLCConfig(**LLC_SMOKE), dram=DRAMConfig(),
                        farm=FarmConfig(nodes=1, passes=1), backend="npu",
                        max_bursts=256, device=CPU)
    want = j_farm.simulate_farm(
        llc=JLLC(**LLC_SMOKE), dram=JDRAM(),
        farm=j_farm.FarmConfig(nodes=1, passes=1), backend="npu",
        max_bursts=256)
    assert res.requests == res.total_latency.shape[0] > 0
    np.testing.assert_array_equal(res.total_latency, want.total_latency)
    assert res.metrics.to_record() == want.metrics.to_record()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        simulate_farm(llc=LLCConfig(), dram=DRAMConfig(), backend="tpu",
                      device=CPU)
    with pytest.raises(ValueError, match="backend"):
        victim_window("tpu")


def test_farm_config_checks_match_reference():
    for bad in (dict(nodes=-1), dict(victim_gap=0), dict(corunner_gap=0),
                dict(passes=0)):
        with pytest.raises(ValueError):
            FarmConfig(**bad)
        with pytest.raises(ValueError):
            j_farm.FarmConfig(**bad)
    assert dataclasses.asdict(FarmConfig()) == \
        dataclasses.asdict(j_farm.FarmConfig())


def test_fig6_tail_smoke_summaries_match_reference():
    """benchmarks/fig6_tail.py's smoke sizes (nodes 0, 1, 2; 512 bursts;
    64 KiB / 8-way / 64 B LLC; unpartitioned and way mask 0x0F): the
    suite's per-node summaries — p50, p99, WCET, mean and n of the
    steady pass, the NoC and memory means, host steps — are the
    reference's ``simulate_farm``'s, run in this test."""
    from repro.utils.stats import latency_summary as j_summary

    llc, jllc = LLCConfig(**LLC_SMOKE), JLLC(**LLC_SMOKE)
    for mask in (None, 0x0F):
        for n in (0, 1, 2):
            res = simulate_farm(llc=llc, dram=DRAMConfig(),
                                farm=FarmConfig(nodes=n, way_mask=mask),
                                max_bursts=512, device=CPU)
            want = j_farm.simulate_farm(
                llc=jllc, dram=JDRAM(),
                farm=j_farm.FarmConfig(nodes=n, way_mask=mask),
                max_bursts=512)
            got_s, want_s = (
                {**summary(r.steady()),
                 "noc_mean": float(r.noc_latency.mean()),
                 "mem_mean": float(r.mem_latency.mean()),
                 "host_steps": r.noc.host_steps}
                for summary, r in ((latency_summary, res),
                                   (j_summary, want)))
            assert got_s == want_s, (n, mask)


def test_chip_smoke_farm_anchors_are_the_references():
    """chip_smoke.py's farm anchors are the reference's fig6_tail
    summaries at the suite's full sizes (2048 bursts, 256 KiB LLC,
    nodes 0, 1, 2 and 4, unpartitioned and 0x0F), recomputed here."""
    import importlib.util
    import pathlib

    from repro.utils.stats import latency_summary as j_summary

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    llc = JLLC(cs.FARM_LLC_BYTES, 8, 64)
    for mask in (None, cs.FARM_MASK):
        for n in cs.FARM_NODES:
            res = j_farm.simulate_farm(
                llc=llc, dram=JDRAM(),
                farm=j_farm.FarmConfig(nodes=n, way_mask=mask),
                max_bursts=cs.FARM_BURSTS)
            assert {**j_summary(res.steady()),
                    "noc_mean": float(res.noc_latency.mean()),
                    "mem_mean": float(res.mem_latency.mean()),
                    "host_steps": res.noc.host_steps} == \
                cs.FARM_ANCHORS[mask][n], (n, mask)

"""The port's NPU backend against the reference, on the CPU: the same
GEMM ops and array configs through ``repro.core.npu`` and
``repro_torch.core.npu`` give the same ``(base, stride, count, stream)``
segments, schedules, workloads and cycle counts, exactly; the NPU's
traces obey the counting laws through the port's lane engine; the
serving oracle's ``backend="npu"`` prices steps as the reference's; and
the sweep mesh shards batch lanes without changing any of them."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import accelerator as j_acc  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.core import npu as j_npu  # noqa: E402
from repro.models import decode_working_set as j_ws  # noqa: E402
from repro.serve import PagedKVCache as JKV  # noqa: E402
from repro.serve import SoCLatencyOracle as JOracle  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import accelerator as t_acc  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.core import npu as t_npu  # noqa: E402
from repro_torch.core import sweep as t_sweep  # noqa: E402
from repro_torch.core.dram import DRAMConfig  # noqa: E402
from repro_torch.core.sweep import MixConfig  # noqa: E402
from repro_torch.launch.mesh import SweepMesh, make_sweep_mesh  # noqa: E402
from repro_torch.models import decode_working_set as t_ws  # noqa: E402
from repro_torch.serve import PagedKVCache as TKV  # noqa: E402
from repro_torch.serve import SoCLatencyOracle as TOracle  # noqa: E402

CPU = "cpu"
LLC_SMALL = (4096, 4, 32)      # (size_bytes, ways, block_bytes)
# the reference test suite's grid: square/rectangular PE arrays,
# buffers from starved (forcing re-stream passes) to roomy
CONFIG_GRID = [
    dict(rows=4, cols=4, ifm_buf_bytes=256, wgt_buf_bytes=128,
         acc_buf_bytes=256),
    dict(rows=4, cols=8, ifm_buf_bytes=128, wgt_buf_bytes=64,
         acc_buf_bytes=128),
    dict(rows=8, cols=4, ifm_buf_bytes=1024, wgt_buf_bytes=4096,
         acc_buf_bytes=512),
    dict(rows=16, cols=16, ifm_buf_bytes=4096, wgt_buf_bytes=512,
         acc_buf_bytes=2048),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def segs(seq) -> list[tuple]:
    return [(s.base, s.stride, s.count, s.stream) for s in seq]


def both_ops(*shape, name="p"):
    return j_npu.GemmOp(name, *shape), t_npu.GemmOp(name, *shape)


def both_cfgs(**kw):
    return j_npu.NPUConfig(**kw), t_npu.NPUConfig(**kw)


# --------------------------------------------------------------------------
# schedules and segments
# --------------------------------------------------------------------------
def test_schedule_segments_and_chunks_match_reference():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(m=st.integers(1, 40), k=st.integers(1, 40), n=st.integers(1, 40),
           cfg=st.sampled_from(CONFIG_GRID),
           order=st.sampled_from(["nm", "mn"]),
           chunk=st.sampled_from([1, 4, 16]),
           max_bursts=st.sampled_from([None, 7, 100]))
    def prop(m, k, n, cfg, order, chunk, max_bursts):
        jop, top = both_ops(m, k, n)
        jc, tc = both_cfgs(**cfg)
        js, ts = j_npu.schedule(jop, jc), t_npu.schedule(top, tc)
        for f in ("m_szs", "k_szs", "n_szs", "stripe_bytes", "stripe_off",
                  "mblock_bytes", "mblock_off", "otile_bytes", "otile_off",
                  "weight_passes", "ifmap_passes", "weight_traffic",
                  "ifmap_traffic", "ofmap_traffic", "compute_cycles"):
            assert getattr(js, f) == getattr(ts, f), f
        assert segs(j_npu.op_segments(jop, jc, 0, 1 << 20, 2 << 20, order)) \
            == segs(t_npu.op_segments(top, tc, 0, 1 << 20, 2 << 20, order))
        ops_j = [jop, j_npu.GemmOp("b", n, m, k)]
        ops_t = [top, t_npu.GemmOp("b", n, m, k)]
        assert segs(j_npu.npu_chunks(ops_j, jc, chunk, order,
                                     max_bursts=max_bursts)) == \
            segs(t_npu.npu_chunks(ops_t, tc, chunk, order,
                                  max_bursts=max_bursts))
        assert segs(j_npu.workload_trace(ops_j, jc, order)) == \
            segs(t_npu.workload_trace(ops_t, tc, order))
        assert segs(j_npu.decode_weight_segments(m * k * n, jc, m=m, k=k)) \
            == segs(t_npu.decode_weight_segments(m * k * n, tc, m=m, k=k))

    prop()


@pytest.mark.parametrize("name", sorted(t_npu.WORKLOADS))
def test_workloads_and_windows_match_reference(name):
    assert [dataclasses.astuple(o) for o in t_npu.workload(name)] == \
        [dataclasses.astuple(o) for o in j_npu.workload(name)]
    assert segs(t_npu.default_npu_window(name, max_bursts=256)) == \
        segs(j_npu.default_npu_window(name, max_bursts=256))


def test_workload_configs_are_the_references_and_serving_archs_unchanged():
    for arch in ("qwen2-0.5b", "whisper-tiny", "internvl2-26b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_get(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(j_smoke(arch))
    assert {"whisper-tiny", "internvl2-26b"} <= set(ARCHS)
    assert len(ARCHS) == 10
    from repro_torch.serve.__main__ import main as serve_main

    for arch in ("whisper-tiny", "internvl2-26b"):
        serve_main(["--arch", arch, "--device", CPU, "--requests", "2",
                    "--prompt-len", "6", "--max-new", "3"])


@pytest.mark.parametrize("case", ["40bit", "heap", "fmap", "config", "op",
                                  "workload", "order"])
def test_refusals_match_reference(case):
    def call(npu):
        op, cfg = npu.GemmOp("square", 12, 12, 12), npu.NPUConfig(**{
            **CONFIG_GRID[0]})
        if case == "40bit":
            npu.op_segments(op, cfg, (1 << 40) - 32, 1 << 20, 2 << 20)
        elif case == "heap":
            npu.workload_op_segments([npu.GemmOp("huge", 1, 1 << 15,
                                                 1 << 15)])
        elif case == "fmap":
            npu.workload_op_segments([npu.GemmOp("wide", 1 << 14, 1,
                                                 1 << 14)])
        elif case == "config":
            npu.NPUConfig(rows=0)
        elif case == "op":
            npu.GemmOp("bad", 1, 0, 1)
        elif case == "workload":
            npu.workload("resnet99")
        else:
            npu.op_segments(op, cfg, 0, 1 << 20, 2 << 20,
                            order=npu.schedule(op, cfg).visits()[:-1])

    with pytest.raises(ValueError) as want:
        call(j_npu)
    with pytest.raises(ValueError) as got:
        call(t_npu)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the timing model
# --------------------------------------------------------------------------
def _mems(llc):
    jm = j_acc.MemSystemConfig(llc=None if llc is None
                               else j_cache.LLCConfig(*llc))
    tm = t_acc.MemSystemConfig(llc=None if llc is None
                               else t_cache.LLCConfig(*llc))
    return jm, tm


@pytest.mark.parametrize("name", sorted(t_npu.WORKLOADS))
def test_model_mode_times_are_exact(name):
    jm, tm = _mems((2 << 20, 16, 64))
    want = j_npu.npu_time_s(j_npu.workload(name), mem=jm)
    got = t_npu.npu_time_s(t_npu.workload(name), mem=tm, device=CPU)
    assert got == want
    for jop, top in zip(j_npu.workload(name)[:8], t_npu.workload(name)[:8]):
        assert t_npu.op_cycles(top, t_npu.NPUConfig(), tm) == \
            j_npu.op_cycles(jop, j_npu.NPUConfig(), jm)


@pytest.mark.parametrize("cfg", CONFIG_GRID[:3], ids=["4x4", "4x8", "8x4"])
@pytest.mark.parametrize("llc", [LLC_SMALL, (16384, 8, 64), None],
                         ids=["4k", "16k", "none"])
def test_simulated_mode_is_exact_on_small_ops(cfg, llc):
    jm, tm = _mems(llc)
    jc, tc = both_cfgs(**cfg)
    shapes = [(9, 8, 7), (7, 7, 9), (16, 16, 16), (3, 30, 5)]
    jops = [j_npu.GemmOp(f"o{i}", *s) for i, s in enumerate(shapes)]
    tops = [t_npu.GemmOp(f"o{i}", *s) for i, s in enumerate(shapes)]
    assert t_npu.op_stream_hit_rates(tops, tc, tm, device=CPU) == \
        j_npu.op_stream_hit_rates(jops, jc, jm)
    assert t_npu.op_stream_hit_rates(tops, tc, tm, max_ops=2,
                                     device=CPU) == \
        j_npu.op_stream_hit_rates(jops, jc, jm, max_ops=2)
    assert t_npu.npu_time_s(tops, npu=tc, mem=tm, mode="simulated",
                            device=CPU) == \
        j_npu.npu_time_s(jops, npu=jc, mem=jm, mode="simulated")


def test_time_validation_and_device_default(monkeypatch):
    ops = [t_npu.GemmOp("a", 4, 4, 4)]
    with pytest.raises(ValueError, match="unknown mode"):
        t_npu.npu_time_s(ops, mode="oracle", device=CPU)
    with pytest.raises(ValueError, match="must cover every op"):
        t_npu.npu_time_s(ops, hit_rates=[], device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("model", "simulated"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_npu.npu_time_s(ops, mode=mode)


# --------------------------------------------------------------------------
# counting laws through the port's lane engine
# --------------------------------------------------------------------------
def test_counting_invariants_through_the_lane_engine():
    """hits <= accesses, DRAM row hits <= misses, and the accelerator
    counters a subset of the lane, for random NPU traces — with the
    lane's DRAM and co-runner mix passed explicitly."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    llc = t_cache.LLCConfig(*LLC_SMALL)

    @settings(max_examples=25, deadline=None)
    @given(m=st.integers(1, 20), k=st.integers(1, 20), n=st.integers(1, 20),
           grid=st.sampled_from([(2, 2), (4, 8), (8, 4)]))
    def prop(m, k, n, grid):
        cfg = t_npu.NPUConfig(rows=grid[0], cols=grid[1], ifm_buf_bytes=128,
                              wgt_buf_bytes=128, acc_buf_bytes=128)
        trace = t_npu.npu_chunks([t_npu.GemmOp("p", m, k, n)], cfg,
                                 chunk_bursts=4)
        res = t_sweep.interference_lane_metrics(
            trace, llc=llc, dram=DRAMConfig(), mix=MixConfig(), device=CPU)
        assert 0 <= res.llc_hits <= res.accesses
        assert res.dram_row_hits <= res.accesses - res.llc_hits
        assert res.nvdla_accesses == sum(s.count for s in trace)
        assert res.nvdla_hits <= res.llc_hits
        want = t_cache.simulate_segments(trace, llc, device=CPU)
        assert (res.accesses, res.llc_hits) == (want.accesses, want.hits)

    prop()


# --------------------------------------------------------------------------
# the serving oracle's NPU weight stream
# --------------------------------------------------------------------------
def _oracle_pair(backend, **kw):
    jws, tws = (j_ws(j_smoke("qwen2-0.5b")),
                t_ws(get_smoke_config("qwen2-0.5b")))
    jo = JOracle(jws, llc=j_cache.LLCConfig(), weight_bytes=1 << 20,
                 backend=backend, **kw)
    to = TOracle(tws, llc=t_cache.LLCConfig(), weight_bytes=1 << 20,
                 backend=backend, device=CPU,
                 **({"npu": t_npu.NPUConfig(**dataclasses.asdict(kw["npu"]))}
                    if kw else {}))
    kvs = []
    for KV in (JKV, TKV):
        kv = KV(num_blocks=32, block_size=16,
                token_bytes=max(1, tws.kv_token_bytes))
        kv.admit(0, prompt_tokens=8, max_new=8)
        kv.admit(1, prompt_tokens=8, max_new=8)
        kvs.append(kv)
    return jo, to, *kvs


@pytest.mark.parametrize("backend,npu", [
    ("nvdla", None), ("npu", None),
    ("npu", j_npu.NPUConfig(rows=8, cols=8, wgt_buf_bytes=1024,
                            acc_buf_bytes=64, ifm_buf_bytes=64))],
    ids=["nvdla", "npu", "npu-starved"])
def test_oracle_backends_price_steps_as_the_reference(backend, npu):
    jo, to, kj, kt = _oracle_pair(backend, **({"npu": npu} if npu else {}))
    for step in (lambda o, k: o.prefill_step(k, [0, 1]),
                 lambda o, k: o.decode_step(k, [0, 1]),
                 lambda o, k: o.prefill_step(k, [1], decode_rids=[0])):
        got, want = step(to, kt), step(jo, kj)
        assert got.metrics.to_record() == want.metrics.to_record()
        assert (got.cycles, got.seconds) == (want.cycles, want.seconds)
    assert to.decode_step(kt, [0, 1]) is to.decode_step(kt, [0, 1])


def test_oracle_npu_weight_stream_overlap_check():
    """3 x 3 tiles of 9 bytes pad to 32-byte bursts, so 152 MiB of
    weights spill past the paged-KV region at 512 MiB."""
    kw = dict(weight_bytes=152 << 20, backend="npu")
    jo = JOracle(j_ws(j_smoke("qwen2-0.5b")),
                 npu=j_npu.NPUConfig(rows=3, cols=3), **kw)
    to = TOracle(t_ws(get_smoke_config("qwen2-0.5b")),
                 npu=t_npu.NPUConfig(rows=3, cols=3), device=CPU, **kw)
    with pytest.raises(ValueError, match="overlap the paged-KV") as want:
        jo._weight_segments(1)
    with pytest.raises(ValueError, match="overlap the paged-KV") as got:
        to._weight_segments(1)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------
# the sweep mesh
# --------------------------------------------------------------------------
def _lanes(n):
    llcs = [t_cache.LLCConfig(16 * w * 64, w, 64) for w in (1, 2, 4)] * 3
    mixes = [MixConfig(c, wss) for c, wss in
             ((0, "l1"), (1, "llc"), (2, "dram"))] * 3
    return llcs[:n], [DRAMConfig()] * n, mixes[:n]


@pytest.mark.parametrize("n_dev,lanes", [(1, 4), (3, 7), (3, 2)])
def test_mesh_batch_equals_one_device_batch(n_dev, lanes):
    window = t_npu.default_npu_window("yolov3", max_bursts=512)
    llcs, drams, mixes = _lanes(lanes)
    want = t_sweep.interference_lane_metrics_batch(
        window, llcs=llcs, drams=drams, mixes=mixes, device=CPU)
    got = t_sweep.interference_lane_metrics_batch(
        window, llcs=llcs, drams=drams, mixes=mixes,
        mesh=make_sweep_mesh([CPU] * n_dev))
    assert got == want
    assert want == [t_sweep.interference_lane_metrics(
        window, llc=c, dram=d, mix=m, device=CPU)
        for c, d, m in zip(llcs, drams, mixes)]


def test_mesh_refuses_way_masked_lanes_and_needs_a_card(monkeypatch):
    window = t_npu.default_npu_window("yolov3", max_bursts=128)
    llcs, drams, mixes = _lanes(2)
    with pytest.raises(ValueError, match="way-masked"):
        t_sweep.interference_lane_metrics_batch(
            window, llcs=llcs, drams=drams, mixes=mixes,
            way_masks=[None, 0x1], mesh=make_sweep_mesh([CPU]))
    mesh = make_sweep_mesh(["cpu", torch.device("cpu")])
    assert mesh == SweepMesh((torch.device("cpu"),) * 2)
    assert mesh.axis_names == ("points",)
    with pytest.raises(RuntimeError, match="at least one device"):
        make_sweep_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sweep_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_sweep_mesh().devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))


def test_npu_window_addresses_fit_the_lane_engine():
    for name in sorted(t_npu.WORKLOADS):
        win = t_npu.default_npu_window(name, max_bursts=128)
        assert sum(s.count for s in win) == 128
        assert all(s.base + s.stride * s.count < 2**31 for s in win)
    assert np.all(np.diff([s.base for s in t_npu.decode_weight_segments(
        1 << 20, m=8)]) > 0)

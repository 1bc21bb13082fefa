"""The port's paper model against the reference: the command stream and
DBB traces item for item, and every closed-form number exactly (`==` on
floats — both sides run the same float64 Python arithmetic)."""
from __future__ import annotations

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import accelerator as j_acc  # noqa: E402
from repro.core import interference as j_int  # noqa: E402
from repro.core import runtime as j_rt  # noqa: E402
from repro.core import soc as j_soc  # noqa: E402
from repro.core import traces as j_tr  # noqa: E402
from repro.core import yolov3 as j_y  # noqa: E402
from repro.core.cache import LLCConfig as JLLC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import accelerator as t_acc  # noqa: E402
from repro_torch.core import interference as t_int  # noqa: E402
from repro_torch.core import runtime as t_rt  # noqa: E402
from repro_torch.core import soc as t_soc  # noqa: E402
from repro_torch.core import traces as t_tr  # noqa: E402
from repro_torch.core import yolov3 as t_y  # noqa: E402

FIG5_SIZES = (0.5, 64, 1024, 4096)
FIG5_BLOCKS = (32, 64, 128)


def _seg(s):
    return (s.base, s.stride, s.count, s.stream)


def test_layer_table_equal_item_for_item():
    assert len(t_y.LAYERS) == len(j_y.LAYERS) == 107
    for a, b in zip(t_y.LAYERS, j_y.LAYERS):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.macs, a.weight_bytes, a.ifmap_bytes, a.ofmap_bytes) == \
            (b.macs, b.weight_bytes, b.ifmap_bytes, b.ofmap_bytes)
    assert t_y.total_gops() == j_y.total_gops()
    assert t_y.total_weight_bytes() == j_y.total_weight_bytes()


@pytest.mark.parametrize("conv_buf", [512 * 1024, 64 * 1024])
def test_command_stream_equal_item_for_item(conv_buf):
    t = t_rt.compile_network(conv_buf_bytes=conv_buf)
    j = j_rt.compile_network(conv_buf_bytes=conv_buf)
    assert [dataclasses.asdict(o) for o in t.accel_ops] == \
        [dataclasses.asdict(o) for o in j.accel_ops]
    assert [dataclasses.asdict(o) for o in t.cpu_ops] == \
        [dataclasses.asdict(o) for o in j.cpu_ops]
    assert (t.total_macs, t.accel_traffic) == (j.total_macs, j.accel_traffic)


def test_network_op_segments_equal_item_for_item():
    t = t_tr.network_op_segments()
    j = j_tr.network_op_segments()
    assert [[_seg(s) for s in ops] for ops in t] == \
        [[_seg(s) for s in ops] for ops in j]
    assert sum(len(o) for o in t) == 328
    assert t_tr.total_bursts(t_tr.network_trace()) == 6_155_982


def test_trace_helpers_equal():
    t = t_tr.default_dbb_window(max_bursts=3000, chunk_bursts=16)
    j = j_tr.default_dbb_window(max_bursts=3000, chunk_bursts=16)
    assert [_seg(s) for s in t] == [_seg(s) for s in j]
    assert (t_tr.expand(t) == j_tr.expand(j)).all()
    segs = t_tr.network_trace(max_ops=3)
    jsegs = j_tr.network_trace(max_ops=3)
    assert [_seg(s) for s in t_tr.interleave(segs, 64)] == \
        [_seg(s) for s in j_tr.interleave(jsegs, 64)]


@pytest.mark.parametrize("kw", [
    dict(base=0, stride=32, count=-1),
    dict(base=0, stride=-32, count=1),
    dict(base=0, stride=0, count=4),
    dict(base=-64, stride=32, count=4),
    dict(base=(1 << 40) - 64, stride=32, count=4),
])
def test_segment_validation_matches(kw):
    with pytest.raises(ValueError) as j_err:
        j_tr.Segment(**kw)
    with pytest.raises(ValueError) as t_err:
        t_tr.Segment(**kw)
    assert str(t_err.value) == str(j_err.value)


def test_model_mode_anchors_exact():
    t, j = t_soc.run_yolov3(), j_soc.run_yolov3()
    assert (t.accel_s, t.cpu_s, t.fps) == (j.accel_s, j.cpu_s, j.fps)
    assert round(t.accel_s * 1e3, 3) == 69.134
    assert round(t.cpu_s * 1e3, 3) == 66.115
    assert round(t.fps, 3) == 7.394
    assert t.detail["accel"]["per_layer"] == j.detail["accel"]["per_layer"]


def test_platform_table_exact():
    t, j = t_soc.platform_table(), j_soc.platform_table()
    assert t == j
    assert round(t["_meta"]["speedup_vs_rocket"], 2) == 406.47


def test_llc_sweep_model_mode_exact():
    t = t_soc.llc_sweep(sizes_kib=FIG5_SIZES, blocks=FIG5_BLOCKS)
    j = j_soc.llc_sweep(sizes_kib=FIG5_SIZES, blocks=FIG5_BLOCKS)
    assert t == j
    g = t["grid"]
    assert round(g[(4096, 128)], 4) == 1.5570
    assert [round(g[(1024, b)], 4) for b in FIG5_BLOCKS] == \
        [1.0611, 1.3414, 1.5455]


def test_interference_sweep_exact():
    t, j = t_soc.interference_sweep(), j_soc.interference_sweep()
    assert t == j
    assert round(t["llc"][4], 4) == 2.0728
    assert round(t["dram"][4], 4) == 2.4457


@pytest.mark.parametrize("wss", ["l1", "llc", "dram"])
@pytest.mark.parametrize("n", [0, 1, 4])
def test_with_corunners_equal(wss, n):
    t = t_int.with_corunners(t_acc.MemSystemConfig(), n, wss)
    j = j_int.with_corunners(j_acc.MemSystemConfig(), n, wss)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_converted_configs_give_equal_results():
    """A non-default SoC built on the reference side, carried across by
    ``convert.to_config``, prices the frame identically in both."""
    j_cfg = j_soc.SoCConfig(
        accel=j_acc.AccelConfig(mlp=2.5, conv_buf_bytes=256 * 1024),
        mem=j_acc.MemSystemConfig(llc=JLLC(512 * 1024, 4, 128),
                                  t_dram_cycles=180.0),
        cpu=j_soc.CpuConfig(cores=2))
    t_cfg = convert.to_config(j_cfg)
    assert isinstance(t_cfg, t_soc.SoCConfig)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    t, j = t_soc.run_yolov3(t_cfg), j_soc.run_yolov3(j_cfg)
    assert (t.accel_s, t.cpu_s) == (j.accel_s, j.cpu_s)
    no_llc = convert.to_config(j_acc.MemSystemConfig(llc=None))
    assert no_llc.llc is None
    with pytest.raises(TypeError, match="no port config"):
        convert.to_config(object())


def test_op_cycles_and_recalibration_exact():
    stream_t, stream_j = t_rt.compile_network(), j_rt.compile_network()
    rates = (0.5, 0.625, 0.25)
    for op_t, op_j in zip(stream_t.accel_ops, stream_j.accel_ops):
        assert t_acc.op_cycles(op_t, t_acc.AccelConfig(),
                               t_acc.MemSystemConfig(), hit_rates=rates) == \
            j_acc.op_cycles(op_j, j_acc.AccelConfig(),
                            j_acc.MemSystemConfig(), hit_rates=rates)
    sim = {(0.5, 64): 0.44, (64, 64): 0.49, (1024, 128): 0.74,
           (4096, 32): 0.05}
    assert t_acc.recalibrate_stream_conflict(sim) == \
        j_acc.recalibrate_stream_conflict(sim)


def test_accel_time_s_validation():
    stream = t_rt.compile_network()
    kw = dict(acc=t_acc.AccelConfig(), mem=t_acc.MemSystemConfig())
    with pytest.raises(ValueError, match="mode"):
        t_acc.accel_time_s(stream, mode="cycle-exact", **kw)
    with pytest.raises(ValueError, match="every op"):
        t_acc.accel_time_s(stream, hit_rates=[(0.5, 0.5, 0.5)], **kw)

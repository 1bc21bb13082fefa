"""The port's launch tooling against the reference's: the collective
parser and roofline terms of tests/test_launch_units.py on the same HLO
text (equal exactly), the trace tally, the production meshes and the
card's constants, the abstract specs of every applicable (arch, shape)
— batch, parameters, decode caches: shapes and dtypes — the analytic
model FLOPs and the skip reasons of all 80 dry-run cells."""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_applicable as j_applicable  # noqa: E402
from repro.launch import hlo_analysis as j_hlo  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import init_caches as j_init_caches  # noqa: E402
from repro.types import is_param as j_is_param  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import model_flops  # noqa: E402
from repro_torch.launch.hlo_analysis import (  # noqa: E402
    collectives_from_trace,
    parse_collectives,
    roofline_terms,
)
from repro_torch.models import init_caches  # noqa: E402
from repro_torch.types import is_param, tree_flatten  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

HLO = """
ENTRY %main {
  %ag = bf16[16,4096]{1,0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%p1), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[64]{0} reduce-scatter(%p2), replica_groups=[32,8]<=[256], dimensions={0}
  %cp = bf16[128,128]{1,0} collective-permute(%p3), source_target_pairs={{0,1}}
  %ags = (bf16[8,8]{1,0}, bf16[64,8]{1,0}) all-gather-start(%p4), replica_groups=[32,8]<=[256]
}
"""

CELLS = [(a, s) for a in ARCHS for s in SHAPES]
# the cells the dry-run traces (the skip reasons are held below)
APPLICABLE = [(a, s) for a, s in CELLS
              if shape_applicable(get_config(a), SHAPES[s])[0]]


# --------------------------------------------------------------------------
# hlo_analysis: twins of tests/test_launch_units.py
# --------------------------------------------------------------------------
def test_parse_collectives_counts_and_groups():
    st = parse_collectives(HLO, n_devices=256)
    assert st.counts == {"all-gather": 2, "all-reduce": 1,
                         "reduce-scatter": 1, "collective-permute": 1}
    assert st.by_group_size["all-gather/16"] == 1
    assert st.by_group_size["all-reduce/4"] == 1
    assert st.by_group_size["reduce-scatter/8"] == 1
    assert dataclasses.asdict(st) == dataclasses.asdict(
        j_hlo.parse_collectives(HLO, n_devices=256))


def test_parse_collectives_wire_bytes():
    st = parse_collectives(HLO, n_devices=256)
    ag = 16 * 4096 * 2 * (15 / 16)              # result x (n-1)/n
    ar = 2 * 1024 * 4 * (3 / 4)
    rs = 64 * 4 * 7                              # shard result x (n-1)
    cp = 128 * 128 * 2
    ags = (8 * 8 + 64 * 8) * 2 // 2 * (7 / 8)    # tuple: half is the result
    assert abs(st.wire_bytes - (ag + ar + rs + cp + ags)) < 1.0
    assert st.wire_bytes == j_hlo.parse_collectives(
        HLO, n_devices=256).wire_bytes


def test_roofline_terms_dominance():
    kw = dict(flops=197e12, bytes_accessed=819e9 * 2, wire_bytes=50e9 * 0.5,
              peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    r = roofline_terms(**kw)
    assert abs(r["compute_s"] - 1.0) < 1e-9
    assert abs(r["memory_s"] - 2.0) < 1e-9
    assert r["dominant"] == "memory"
    assert abs(r["roofline_fraction"] - 0.5) < 1e-9
    assert r == j_hlo.roofline_terms(**kw)


def test_trace_tally_uses_the_ring_formulas():
    trace = [("all_gather_into_tensor", 16 * 4096 * 2, 16),
             ("all_reduce", 1024 * 4, 4),
             ("reduce_scatter_tensor", 64 * 4, 8),
             ("all_to_all_single", 100, 0)]     # 0: the whole world
    st = collectives_from_trace(trace, n_devices=256)
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "reduce-scatter": 1, "all-to-all": 1}
    assert st.by_group_size["all-to-all/256"] == 1
    want = (16 * 4096 * 2 * 15 / 16 + 2 * 1024 * 4 * 3 / 4 + 64 * 4 * 7
            + 100 * 255 / 256)
    assert abs(st.wire_bytes - want) < 1e-6
    with pytest.raises(ValueError, match="no cost formula"):
        collectives_from_trace([("barrier", 0, 2)], n_devices=2)


# --------------------------------------------------------------------------
# meshes and the card's constants
# --------------------------------------------------------------------------
def test_production_meshes_have_the_references_axes():
    pod = mesh_mod.make_production_mesh()
    multi = mesh_mod.make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.shape, pod.size) == (("data", "model"),
                                                     (16, 16), 256)
    assert (multi.axis_names, multi.shape, multi.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert pod.device_mesh is None and multi.device_mesh is None


def test_host_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_host_mesh()


def test_constants_are_the_cards():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert mesh_mod.PEAK_BF16_FLOPS == chip_smoke.BF16_OPS_PER_S
    assert mesh_mod.PEAK_INT8_OPS == chip_smoke.INT8_OPS_PER_S
    assert mesh_mod.HBM_BW == chip_smoke.HBM_BYTES_PER_S


# --------------------------------------------------------------------------
# abstract specs, model FLOPs and skips against the reference
# --------------------------------------------------------------------------
def _sig(x):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _param_sigs(tree, flatten):
    return [(_sig(p.value), p.axes) for p in flatten(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    got = _param_sigs(specs.abstract_params(get_config(arch)),
                      lambda t: tree_flatten(t, is_leaf=is_param)[0])
    want = _param_sigs(j_specs.abstract_params(j_get_config(arch)),
                       lambda t: jax.tree.leaves(t, is_leaf=j_is_param))
    assert got == want


@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_batch_and_cache_specs_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sh, jsh = SHAPES[shape], J_SHAPES[shape]
    assert specs.token_count(cfg, sh) == j_specs.token_count(jcfg, jsh)
    for labels in (False, True):
        got = {k: _sig(v) for k, v in specs.batch_specs(
            cfg, sh, with_labels=labels).items()}
        want = {k: _sig(v) for k, v in j_specs.batch_specs(
            jcfg, jsh, with_labels=labels).items()}
        assert got == want
    if sh.mode == "decode":
        got = _param_sigs(init_caches(cfg, sh.global_batch, sh.seq_len,
                                      device="meta"),
                          lambda t: tree_flatten(t, is_leaf=is_param)[0])
        want = _param_sigs(j_init_caches(jcfg, jsh.global_batch,
                                         jsh.seq_len, abstract=True),
                           lambda t: jax.tree.leaves(t, is_leaf=j_is_param))
        assert got == want


def _reference_model_flops():
    """The reference's ``_model_flops``, read from its source (importing
    ``repro.launch.dryrun`` would set XLA_FLAGS in this process)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_model_flops")
    ns = {"token_count": j_specs.token_count}
    exec(compile(ast.Module([fn], []), "dryrun.py", "exec"), ns)
    return ns["_model_flops"]


def test_model_flops_and_skips_match_reference_for_all_80_cells():
    j_model_flops = _reference_model_flops()
    n = 0
    for arch, shape in CELLS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        sh, jsh = SHAPES[shape], J_SHAPES[shape]
        for _mesh in ("pod", "multipod"):   # neither depends on the mesh
            assert shape_applicable(cfg, sh) == j_applicable(jcfg, jsh)
            assert model_flops(cfg, sh) == j_model_flops(jcfg, jsh)
            n += 1
    assert n == 80
    assert len(CELLS) - len(APPLICABLE) == 7


# --------------------------------------------------------------------------
# the kernels' meta routes: shapes, and the bounds' FLOP counts
# --------------------------------------------------------------------------
def test_swa_meta_route_records_the_bound_counts():
    from repro_torch.kernels import meta
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.kernels.swa import ops as swa_ops

    b, s, hq, hkv, d, window = 2, 40, 4, 2, 16, 8
    q = torch.empty((b, s, hq, d), device="meta", requires_grad=True)
    k = torch.empty((b, s, hkv, d), device="meta", requires_grad=True)
    before = swa_kernel.launches
    with meta.recording() as log:
        o = swa_ops.swa_attention(q, k, k, window=window)
        (gq,) = torch.autograd.grad(o.sum(), q)
    pairs = sum(min(i + 1, window) for i in range(s))
    assert o.shape == q.shape and gq.shape == q.shape
    assert swa_kernel.launches == before          # nothing launched
    assert log == [("swa", 4 * d * pairs * hq * b,
                    4 * 2 * (b * s * hq * d + b * s * hkv * d)),
                   ("swa_bwd", 10 * d * pairs * hq * b,
                    4 * 4 * (b * s * hq * d + b * s * hkv * d))]

"""CPU tests of the benchmark's pieces: finding cells by name, the
yardstick's arithmetic, the frozen stream, what the modules import."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, peaks, roofline, stream, tiny, trace, weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metric(name: str):
    return harness.load_module(HERE / "metrics" / f"{name}.py")


def test_the_harness_finds_a_configuration_mix_and_metric_added_as_files(
        tmp_path):
    root, _ = tiny.tiny_root(tmp_path, "qwen2-0.5b")
    base = root / "portbench"
    cfg = json.loads((base / "configs" / "qwen2-0.5b.json").read_text())
    cfg["name"] = "added-model"
    (base / "configs" / "added-model.json").write_text(json.dumps(cfg))
    (base / "traffic" / "added-mix.json").write_text(json.dumps(
        {"kind": "train", "global_batch": 3, "seq_len": 5,
         "setup_steps": 1, "profiled_steps": 1}))
    (base / "limits" / "added-model.added-mix.json").write_text(
        json.dumps({"limits": {"grad_gap": 0.5}}))
    (base / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return len(run['steps']) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "added-model.added-mix",
                               "config": "added-model",
                               "traffic": "added-mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "train_tokens_per_s",
                               "workloads": ["added-model.added-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("added-model.added-mix", root)
    assert cell.config["name"] == "added-model"
    assert cell.traffic["global_batch"] == 3
    assert cell.limits == {"grad_gap": 0.5}
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    assert harness.driver(cell).__name__ != harness.driver(
        harness.load_cell(BENCH["workloads"][0]["name"], ROOT)).__name__
    record = {"steps": [(0.0, 0.0, 0.0)] * 4, "trace": None}
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert harness.read_metrics(cell, record, True) == {
        "steps_seen": {"value": 4, "unit": "steps"}}
    # a reader that finds nothing leaves its metric out of the line
    record["steps"] = []
    assert "steps_seen" not in harness.read_metrics(cell, record, True)


def test_every_cell_finds_its_pieces():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert cell.limits and set(cell.limits) <= {
            "first_loss_gap", "later_loss_gap", "grad_gap", "grad_median_gap",
            "update_gap"}
        assert harness.driver(cell).run
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        for name in names:
            assert callable(harness.reader(cell, name).read), name
        assert "setup_s" in names and "train_mfu" in names


@pytest.mark.parametrize("metric, flops, nbytes", [
    # 2 rows of 8 positions, 4 query / 2 KV heads of 16, bf16: 36 causal
    # pairs a row; 4 x 16 operations a pair and query head; q, k, v, o
    ("swa_roofline", 4 * 16 * 36 * 4 * 2, 2 * 2 * 8 * 16 * (4 + 2 + 2 + 4)),
    # 8 x 16 a pair and head; q, k, v, o, dO read, dq, dk, dv written
    ("swa_bwd_roofline", 8 * 16 * 36 * 4 * 2,
     2 * 2 * 8 * 16 * (4 * 4 + 4 * 2)),
])
def test_attention_work_by_hand(metric, flops, nbytes):
    m = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "dtype": "bfloat16"}
    assert _metric(metric).work(m, 2, 8) == (flops, nbytes)


# one row of 8 positions in 2 chunks of 4 (10 causal pairs a chunk), 2
# heads of 8, one group, state 4, float32
SSD_M = {"ssm_chunk": 4, "ssm_expand": 2, "d_model": 8, "ssm_head_dim": 8,
         "ssm_ngroups": 1, "ssm_state": 4}


@pytest.mark.parametrize("metric, flops, nbytes", [
    # C.B^T 2*10*4; per head scores.x 2*10*8 and the state 2*4*4*8
    ("ssd_roofline", 2 * (2 * 10 * 4 + 2 * (2 * 10 * 8 + 2 * 4 * 4 * 8)),
     4 * 2 * (2 * 4 * 2 * 8 + 2 * 4 * 8 + 2 * 4 * 4 + 2 * 4 * 2)),
    # per head dS and dx over the pairs (4*10*8), the states' part of dx
    # and dB (4*4*4*8); dC and dB over the pairs (4*10*4)
    ("ssd_bwd_roofline",
     2 * (2 * (4 * 10 * 8 + 4 * 4 * 4 * 8) + 4 * 10 * 4),
     4 * 2 * (3 * 4 * 2 * 8 + 4 * 4 * 2 + 4 * 4 * 4 + 2 * 4 * 8)),
])
def test_ssd_work_by_hand(metric, flops, nbytes):
    assert _metric(metric).work(SSD_M, 1, 8) == (flops, nbytes)


def test_a_roofline_share_and_its_silence():
    tr = trace.Trace(ops=[("void swa_tc_kernel<64, true>(...)", 0.0, 2e-3),
                          ("void swa_bwd_tc_dq<64>(...)", 2e-3, 5e-3),
                          ("ampere_gemm", 5e-3, 6e-3)],
                     spans=[("dispatch", 0.0, 6e-3)])
    m = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "dtype": "bfloat16"}
    run = {"trace": tr, "config": {"model": m},
           "traffic": {"global_batch": 2, "seq_len": 8},
           "launches": {("repro_torch.kernels.swa.kernel", "launches"): 3}}
    flops, nbytes = _metric("swa_roofline").work(m, 2, 8)
    want = 100 * 3 * max(flops / peaks.BF16_FLOPS,
                         nbytes / peaks.HBM_BYTES_PER_S) / 2e-3
    assert _metric("swa_roofline").read(run) == pytest.approx(want)
    # the backward's counter saw no call: nothing to read, never 0
    assert _metric("swa_bwd_roofline").read(run) is None
    run["trace"] = trace.Trace(ops=[("ampere_gemm", 0.0, 1e-3)],
                               spans=[("dispatch", 0.0, 1e-3)])
    assert _metric("swa_roofline").read(run) is None


def test_trace_busy_share_and_idle_gaps():
    tr = trace.Trace(ops=[("a", 1.0, 2.0), ("b", 1.5, 3.0), ("a", 4.0, 4.5)],
                     spans=[("data", 0.0, 1.0), ("dispatch", 1.0, 3.2),
                            ("barrier", 3.2, 5.0)])
    assert tr.busy() == [(1.0, 3.0), (4.0, 4.5)]
    assert tr.busy_s() == pytest.approx(2.5)
    assert tr.top_ops() == [["a", 1.5], ["b", 1.5]]
    assert tr.idle_gaps() == [["host in data", 1.0],
                              ["host in barrier", 1.0],
                              ["host in barrier", 0.5]]
    assert tr.kernel_seconds(re.compile("^a$")) == (1.5, 2)


@pytest.mark.parametrize("config, per_token", [
    # 24 x (wq 896*896 + wk, wv 2*896*128 + wo 896*896 + 3*896*4864)
    # + unembed 151,936*896 products; attention 3 x 24 layers x 4 x 64 x
    # 14 heads x 512.5 causal keys a query at 1,024
    ("qwen2-0.5b", 6 * (24 * (896 * 896 * 2 + 2 * 896 * 128
                              + 3 * 896 * 4864) + 151936 * 896)
     + 3 * 24 * 4 * 64 * 14 * 512.5),
    # 24 x (in_proj 768*(2*1536 + 2*128 + 24) + out_proj 1536*768)
    # + unembed 50,280*768; the SSD's chunk of 256: C.B^T over 32,896
    # pairs (state 128), scores.x (24 heads of 64), the states in and
    # out (2 x 256*128*64 a head), over 256 tokens, x 24 layers x 3
    ("mamba2-130m", 6 * (24 * (768 * 3352 + 1536 * 768) + 50280 * 768)
     + 3 * 24 * (2 * 32896 * 128 + 2 * 32896 * 64 * 24
                 + 4 * 256 * 128 * 64 * 24) / 256),
])
def test_model_flops_a_token_by_hand(config, per_token):
    m = json.loads((HERE / "configs" / f"{config}.json").read_text())["model"]
    seq = {"qwen2-0.5b": 1024, "mamba2-130m": 2048}[config]
    flops = _metric("train_mfu").step_flops(m, 16, seq)
    assert flops / (16 * seq) == pytest.approx(per_token, rel=1e-12)


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in BENCH["workloads"]}))
def test_the_frozen_stream_is_the_ports_bit_for_bit(mix):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.synthetic import SyntheticStream

    traffic = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    configs = {w["config"] for w in BENCH["workloads"]
               if w["traffic"] == mix}
    assert configs
    for name in sorted(configs):
        m = json.loads((HERE / "configs" / f"{name}.json").read_text())[
            "model"]
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in m.items()})
        b, s, seed = traffic["global_batch"], traffic["seq_len"], 2**31 + 7
        port = SyntheticStream(cfg, b, s, seed=seed)
        for step in (0, 2):
            toks, labs = stream.batch_at(m["vocab_size"], b, s, seed, step)
            batch = port.batch_at(step)
            assert np.array_equal(batch["tokens"].numpy(), toks)
            assert np.array_equal(batch["labels"].numpy(), labs)


def test_weights_follow_the_init_rules_and_the_seed():
    shapes = {"embed.embed": (16, 8), "blocks.0.attn.wq": (2, 8, 2, 4),
              "blocks.0.ssm.A_log": (2, 4), "blocks.0.norm1.scale": (2, 8),
              "blocks.0.attn.bq": (2, 2, 4)}
    init = [{"match": r"embed\.embed", "init": "normal", "fan_dims": [-1]},
            {"match": r".*\.wq", "init": "normal", "fan_dims": [-3]},
            {"match": r".*A_log", "init": "log_linspace", "low": 1.0,
             "high": 16.0},
            {"match": r".*\.b[qkv]", "init": "zeros"},
            {"match": r".*scale", "init": "ones"}]
    a = weights.make(shapes, init, 2**31 + 3, "cpu")
    b = weights.make(shapes, init, 2**31 + 3, "cpu")
    c = weights.make(shapes, init, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["embed.embed"], c["embed.embed"])
    assert {k: tuple(v.shape) for k, v in a.items()} == shapes
    assert torch.equal(a["blocks.0.norm1.scale"], torch.ones(2, 8))
    assert torch.equal(a["blocks.0.attn.bq"], torch.zeros(2, 2, 4))
    assert torch.allclose(a["blocks.0.ssm.A_log"][1],
                          torch.log(torch.linspace(1.0, 16.0, 4)))
    # one normal_ draw, each leaf scaled by 1/sqrt of its fan
    flat = torch.empty(16 * 8 + 2 * 8 * 2 * 4).normal_(
        generator=torch.Generator().manual_seed(2**31 + 3))
    assert torch.allclose(a["embed.embed"].flatten(),
                          flat[:128] / 8 ** 0.5)
    assert torch.allclose(a["blocks.0.attn.wq"].flatten(),
                          flat[128:] / 8 ** 0.5)
    with pytest.raises(KeyError):
        weights.make({"nowhere": (2,)}, init, 1, "cpu")


def test_each_configuration_has_every_leaf_of_the_port():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.types import param_values

    from portbench.drivers import train as drv
    from portbench.reference import train as ref_train

    for name in sorted({w["config"] for w in BENCH["workloads"]}):
        config = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in config["model"].items()})
        port = {k: tuple(v.shape) for k, v in drv._leaves(
            param_values(init_params(0, cfg, device="meta")))}
        fam = ref_train.family(config)
        assert fam.shapes(config["model"], config["layout"]) == port


FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def test_nothing_imports_jax_or_the_jax_package_and_the_reference_no_port():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        tops = _imports(path)
        # whole top-level names: repro_torch is not repro
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.relative_to(HERE).parts:
            assert "repro_torch" not in tops, path
    assert _imports(HERE / "drivers" / "train.py") >= {"torch", "portbench"}


def test_the_run_looks_for_loaded_jax_by_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in [n for n in sys.modules
                 if n.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("j"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("r"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_loaded() == ["jax", "repro"]


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(989e12, 0.0, peaks.BF16_FLOPS) == \
        pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12, peaks.BF16_FLOPS) == \
        pytest.approx(1.0)
    assert roofline.causal_pairs(4) == 10

"""CPU tests of the check that decides ``correct``, at smoke size.

Each drives a whole run of a smoke-size cell (``portbench/tiny.py``)
through ``harness.run_cell`` (everything ``run.py`` does after its look
for a card) on the CPU, where the port runs its kernels' plain
versions: a sound run comes out correct; a run with the timed path
broken underneath comes out not correct, once for each fault a
one-card training cell can have; and the control, the reference with
float8 products in the program's place, fails the limits.
"""
from __future__ import annotations

import time

import pytest

from portbench import correctness, harness, tiny
from portbench.reference import train as ref_train

CONFIGS = ("qwen2-0.5b", "mamba2-130m")


def _run(tmp_path, config, seed, traced=False, fault=None):
    root, name = tiny.tiny_root(tmp_path, config)
    cell = harness.load_cell(name, root)
    return harness.run_cell(cell, seed=seed, seconds=0.2, traced=traced,
                            device="cpu", t_start=time.perf_counter(),
                            fault=fault)


@pytest.mark.parametrize("config", CONFIGS)
def test_a_sound_run_is_correct_and_reports_its_metrics(tmp_path, config):
    result, lines = _run(tmp_path, config, seed=2**31 + 11)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "train_tokens_per_s"}
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"first_loss_gap", "later_loss_gap", "grad_gap",
                                      "update_gap"}
    assert lines[-4:] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in result["checks"].items()]


@pytest.mark.parametrize("config", CONFIGS)
def test_a_traced_run_reports_the_host_side_per_layer_metrics(tmp_path,
                                                              config):
    result, _ = _run(tmp_path, config, seed=1, traced=True)
    assert result["correct"] is True
    # no device here: the device's readers find nothing and stay silent
    assert set(result["metrics"]) == {"data_ms", "dispatch_ms", "train_mfu"}
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("config", CONFIGS)
def test_a_broken_timed_path_is_not_correct(tmp_path, config, fault):
    result, lines = _run(tmp_path, config, seed=2, fault=fault)
    assert result["correct"] is False
    assert any(line.endswith("FAILS") for line in lines)


@pytest.mark.parametrize("config", CONFIGS)
def test_the_float8_control_is_not_correct(tmp_path, config):
    """float8, the control of a bf16 configuration, and a control that
    acts on the CPU for the float32 one too."""
    root, name = tiny.tiny_root(tmp_path, config)
    cell = harness.load_cell(name, root)
    ref = ref_train.follow(cell.config, cell.traffic, 3, "cpu", 3)
    low = ref_train.follow(cell.config, cell.traffic, 3, "cpu", 3, "fp8")
    correct, checks = correctness.judge(correctness.numbers(low, ref),
                                        cell.limits)
    assert not correct, checks
    same, _ = correctness.judge(correctness.numbers(ref, ref), cell.limits)
    assert same


@pytest.mark.gpu
def test_the_tf32_control_is_not_correct_on_card(tmp_path):
    """TF32, the float32 configuration's control, acts only on a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products run only there")
    root, name = tiny.tiny_root(tmp_path, "mamba2-130m")
    cell = harness.load_cell(name, root)
    assert cell.config["precision"]["control"] == "tf32"
    ref = ref_train.follow(cell.config, cell.traffic, 3, "cuda", 3)
    low = ref_train.follow(cell.config, cell.traffic, 3, "cuda", 3, "tf32")
    correct, checks = correctness.judge(correctness.numbers(low, ref),
                                        cell.limits)
    assert not correct, checks

"""``python -m repro_torch.quickstart``, the twin of the reference's
``examples/quickstart.py``: its paper numbers are the reference's own
functions' values exactly (the closed-form model in the same float64
arithmetic), and its training and serving parts run on the CPU."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro.core import interference_sweep, llc_sweep, run_yolov3  # noqa: E402
from repro_torch import quickstart  # noqa: E402


def test_paper_numbers_are_the_references(capsys):
    got = quickstart.paper_experiments()
    r = run_yolov3()
    sw = llc_sweep(sizes_kib=(1024,), blocks=(32, 64, 128))
    isw = interference_sweep(corunners=(0, 4))
    assert (got["fps"], got["accel_s"], got["cpu_s"]) == (r.fps, r.accel_s,
                                                          r.cpu_s)
    assert got["llc_1mib"] == {b: sw["grid"][(1024, b)] for b in (32, 64, 128)}
    assert (got["llc_x4"], got["dram_x4"]) == (isw["llc"][4], isw["dram"][4])
    out = capsys.readouterr().out
    assert "7.39 fps" in out and "32B 1.06x  64B 1.34x  128B 1.55x" in out \
        and "LLC-WSS 2.07x, DRAM-WSS 2.45x" in out


def test_quickstart_runs_on_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step  15  loss" in out and "served 4 requests" in out
    assert out.rstrip().endswith("quickstart complete.")


def test_training_and_serving_parts():
    """Three steps of qwen2's reduced config with finite losses, then
    four requests served."""
    cfg, state, losses = quickstart.train_small_lm(3, device="cpu")
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    assert int(state.step) == 3
    stats = quickstart.serve_small_lm(cfg, state, device="cpu")
    assert stats.requests == 4 and stats.tokens >= 4

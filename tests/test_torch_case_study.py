"""The slice as a whole: the case study's int8 numeric stage runs in
both packages from the same numpy input and weights (carried across by
``repro_torch.convert``), and ``python -m repro_torch`` runs end to end
on the CPU."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.quant import calibrate, quantize, quantize_conv_weights  # noqa: E402
from repro.kernels.convcore import conv2d_int8  # noqa: E402
from repro.kernels.postproc import postprocess  # noqa: E402
from repro_torch import case_study, convert  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run many small ops, which intra-op threads
    only slow down — and parallel test workers would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _reference_stage(x, params):
    """The reference's stage, as examples/yolov3_soc_sim.py runs it
    (Pallas kernels in interpret mode)."""
    sx = calibrate(x)
    acc = quantize(x, sx)
    outs = []
    for p in params:
        out = conv2d_int8(acc, jnp.asarray(p["w"]), sx * p["w_scale"],
                          jnp.asarray(p["bias"]), stride=p["stride"],
                          padding=p["padding"], relu=True,
                          out_dtype=jnp.float32, interpret=True)
        outs.append(out)
        sx = calibrate(out)
        acc = quantize(out, sx)
    c = out.shape[-1]
    pooled = postprocess(out, jnp.ones((c,)), jnp.zeros((c,)), act="none",
                         pool=2, interpret=True)
    return outs, pooled


def test_numeric_stage_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    params, cin = [], 3
    for cout, k, stride in case_study.STAGE_CONVS:
        w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
        wq, sw = quantize_conv_weights(jnp.asarray(w))
        params.append({"w": np.asarray(wq), "w_scale": np.asarray(sw),
                       "bias": np.zeros(cout, np.float32),
                       "stride": stride, "padding": 1})
        cin = cout
    j_outs, j_pooled = _reference_stage(jnp.asarray(x), params)
    res = case_study.int8_stage(torch.from_numpy(x),
                                convert.stage_layers(params, device="cpu"))
    assert len(res["convs"]) == len(j_outs) == 2
    for (inp, out, ref), j_out in zip(res["convs"], j_outs):
        assert inp.dtype == torch.int8
        assert tuple(out.shape) == tuple(j_out.shape)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(out, ref)
    assert tuple(res["pooled"].shape) == (1, 16, 16, 64)
    assert res["pooled"].dtype == torch.bfloat16
    np.testing.assert_allclose(res["pooled"].float().numpy(),
                               np.asarray(j_pooled, np.float32),
                               rtol=2 ** -7, atol=1e-5)


def test_stage_layers_rejects_wrong_dtypes():
    p = {"w": np.zeros((3, 3, 3, 4), np.float32),
         "w_scale": np.ones(4, np.float32), "bias": np.zeros(4, np.float32)}
    with pytest.raises(TypeError, match="int8"):
        convert.stage_layers([p], device="cpu")


def test_case_study_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "--device", "cpu",
         "--size", "32"],
        env={"PYTHONPATH": str(SRC), "PATH": "", "OMP_NUM_THREADS": "1"},
        capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "YOLOv3-416: 107 layers, 65.9 GOP/frame" in text
    assert "conv1: (1, 32, 32, 32) -> (1, 16, 16, 64)" in text
    assert "postproc 2x2 maxpool: (1, 16, 16, 64) -> (1, 8, 8, 64)" in text
    assert "NVDLA split: 69.1 ms accel + 66.1 ms cpu" in text
    assert "simulated mode (exact LLC replay on cpu): 65.138 ms" in text
    assert "4096.0 KiB / 128 B : 1.647x" in text

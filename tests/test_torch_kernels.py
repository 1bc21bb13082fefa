"""The port's kernel ops on the CPU (their plain versions) against the
reference's Pallas ops (interpret mode) and pure-jnp oracles, at the
shapes of tests/test_kernels.py; the kernels themselves against their
plain versions on a card (``gpu`` marker).

Tolerances: int8 x int8 accumulation is exact; the fp32 epilogue and
post-processing agree within rtol = atol = 1e-5 (sigmoid/tanh are
different libm implementations); bf16 outputs within one bf16 ulp."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quant as j_quant  # noqa: E402
from repro.kernels.convcore import conv2d_int8 as j_conv2d  # noqa: E402
from repro.kernels.convcore import matmul_int8 as j_matmul  # noqa: E402
from repro.kernels.convcore.ref import matmul_int8_ref as j_mm_ref  # noqa: E402
from repro.kernels.postproc import postprocess as j_post  # noqa: E402
from repro_torch.core import quant as t_quant  # noqa: E402
from repro_torch.kernels.convcore import kernel as t_cc_kernel  # noqa: E402
from repro_torch.kernels.convcore import ops as t_cc  # noqa: E402
from repro_torch.kernels.convcore.ref import conv2d_int8_ref  # noqa: E402
from repro_torch.kernels.convcore.ref import matmul_int8_ref  # noqa: E402
from repro_torch.kernels.postproc import kernel as t_pp_kernel  # noqa: E402
from repro_torch.kernels.postproc import ops as t_pp  # noqa: E402
from repro_torch.kernels.postproc.ref import postprocess_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths run many small ops, which intra-op threads
    only slow down — and parallel test workers would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


def _np(x):
    """Port or reference output -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        # one bf16 ulp: 2^-7 relative to the larger magnitude's exponent
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp + 1e-30), \
            float(np.max(np.abs(got - want) / (ulp + 1e-30)))
    else:
        np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------------------
# convcore
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128),
    (256, 512, 256),
    (384, 640, 128),
    (100, 200, 60),       # ragged
    (1, 2048, 1000),      # FC-layer shape
])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_int8_matches_reference(m, k, n, relu, dtype):
    rng = np.random.default_rng(m * n + k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    jd, td = DTYPES[dtype]
    got = t_cc.matmul_int8(*map(torch.from_numpy, (a, b, scale, bias)),
                           relu=relu, out_dtype=td)
    assert got.dtype == td and tuple(got.shape) == (m, n)
    ja = [jnp.asarray(v) for v in (a, b, scale, bias)]
    _assert_close(got, j_matmul(*ja, relu=relu, out_dtype=jd,
                                interpret=True, bm=128, bn=128, bk=128),
                  dtype)
    _assert_close(got, j_mm_ref(*ja, relu=relu, out_dtype=jd), dtype)


def test_matmul_int8_exact_int_accumulation():
    rng = np.random.default_rng(0)
    a, b = _int8(rng, (128, 256)), _int8(rng, (256, 128))
    a[0, :] = 127
    b[:, 0] = 127                 # the largest product sum of this shape
    out = t_cc.matmul_int8(torch.from_numpy(a), torch.from_numpy(b),
                           out_dtype=torch.float32)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(out.numpy().astype(np.int64), exact)


@pytest.mark.parametrize("hw,cin,cout,kk,stride,pad", [
    (8, 16, 32, 3, 1, 1),     # 3x3 same conv
    (16, 3, 8, 3, 2, 1),      # strided downsample (darknet)
    (8, 32, 16, 1, 1, 0),     # 1x1 bottleneck
    (13, 5, 7, 3, 2, 1),      # odd sizes
])
def test_conv2d_int8_matches_reference(hw, cin, cout, kk, stride, pad):
    rng = np.random.default_rng(hw * cin)
    x, w = _int8(rng, (2, hw, hw, cin)), _int8(rng, (kk, kk, cin, cout))
    scale = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    kw = dict(stride=stride, padding=pad, relu=True)
    got = t_cc.conv2d_int8(*map(torch.from_numpy, (x, w, scale, bias)),
                           out_dtype=torch.float32, **kw)
    want = j_conv2d(*map(jnp.asarray, (x, w, scale, bias)),
                    out_dtype=jnp.float32, interpret=True, **kw)
    _assert_close(got, want, "float32")
    # the direct (per-tap) plain conv agrees exactly with im2col + GEMM
    direct = conv2d_int8_ref(*map(torch.from_numpy, (x, w, scale, bias)),
                             out_dtype=torch.float32, **kw)
    assert torch.equal(got, direct)


def test_im2col_orders_patches_like_hwio_weights():
    x = torch.arange(2 * 5 * 5 * 3, dtype=torch.int64).reshape(2, 5, 5, 3)
    patches, (ho, wo) = t_cc.im2col(x, 3, 3, stride=2, padding=1)
    assert (ho, wo) == (3, 3) and tuple(patches.shape) == (18, 27)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    # output (n=1, oh=2, ow=1): rows 4..6, cols 2..4, channels innermost
    want = xp[1, 4:7, 2:5, :].reshape(-1)
    assert torch.equal(patches[1 * 9 + 2 * 3 + 1], want)


# --------------------------------------------------------------------------
# postproc
# --------------------------------------------------------------------------
@pytest.mark.parametrize("h,w,c,act,pool", [
    (32, 32, 16, "relu", 1),
    (32, 32, 16, "relu", 2),
    (64, 64, 8, "sigmoid", 2),
    (30, 30, 8, "none", 2),     # ragged H/W with pooling
    (31, 29, 8, "tanh", 2),     # ragged, odd
    (16, 16, 128, "tanh", 1),
    (16, 16, 8, "sigmoid", 1),
    (12, 18, 8, "none", 3),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_postprocess_matches_reference(h, w, c, act, pool, dtype):
    rng = np.random.default_rng(h + c + pool)
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    scale = rng.uniform(-2.0, 2.0, c).astype(np.float32)  # some negative
    bias = rng.standard_normal(c).astype(np.float32)
    xt = torch.from_numpy(x).to(td)
    got = t_pp.postprocess(xt, torch.from_numpy(scale),
                           torch.from_numpy(bias), act=act, pool=pool,
                           out_dtype=td)
    assert got.dtype == td
    assert tuple(got.shape) == (2, h // pool, w // pool, c)
    want = j_post(jnp.asarray(x).astype(jd), jnp.asarray(scale),
                  jnp.asarray(bias), act=act, pool=pool, out_dtype=jd,
                  interpret=True)
    assert tuple(want.shape) == tuple(got.shape)
    _assert_close(got, want, dtype)


def test_ops_validate_their_inputs():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        t_cc.matmul_int8(a.float(), a.t())
    with pytest.raises(ValueError, match="M, K"):
        t_cc.matmul_int8(a, a)
    with pytest.raises(ValueError, match="scale and bias"):
        t_cc.matmul_int8(a, a.t().contiguous(), torch.ones(3))
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="activation"):
        t_pp.postprocess(x, torch.ones(2), torch.zeros(2), act="gelu")
    with pytest.raises(ValueError, match="scale and bias"):
        t_pp.postprocess(x, torch.ones(3), torch.zeros(3))
    # a device with neither the kernel nor the plain version raises
    with pytest.raises(ValueError, match="cuda"):
        t_cc.matmul_int8(a.to("meta"), a.t().contiguous().to("meta"),
                         torch.ones(4, device="meta"),
                         torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="cuda"):
        t_pp.postprocess(x.to("meta"), torch.ones(2, device="meta"),
                         torch.zeros(2, device="meta"))


def test_kernel_launchers_refuse_what_the_kernels_do_not_take():
    a = torch.zeros((4, 32), dtype=torch.int8)
    f32 = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA device"):
        t_cc_kernel.matmul_int8_kernel(a, a, f32, f32,
                                       torch.empty((4, 4)), relu=False)
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="CUDA device"):
        t_pp_kernel.postprocess_kernel(x, torch.ones(2), torch.zeros(2),
                                       torch.empty((1, 2, 2, 2)),
                                       act="none", pool=2)


def test_cpu_tensors_never_launch_a_kernel():
    before = (t_cc_kernel.launches, t_pp_kernel.launches)
    a = torch.ones((8, 8), dtype=torch.int8)
    t_cc.conv2d_int8(torch.ones((1, 4, 4, 8), dtype=torch.int8),
                     torch.ones((3, 3, 8, 4), dtype=torch.int8), padding=1)
    t_cc.matmul_int8(a, a)
    t_pp.postprocess(torch.ones((1, 4, 4, 2)), torch.ones(2),
                     torch.zeros(2), pool=2)
    assert (t_cc_kernel.launches, t_pp_kernel.launches) == before


# --------------------------------------------------------------------------
# quant
# --------------------------------------------------------------------------
def test_quant_matches_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 64)) * 0.3).astype(np.float32)
    # exact half-way points: round half to even on both sides
    x[0, :8] = np.float32(0.3) * np.asarray([0.5, 1.5, 2.5, -0.5, -2.5,
                                             126.5, -126.5, 127.0],
                                            np.float32) / 127.0
    s_t = t_quant.calibrate(torch.from_numpy(x))
    s_j = j_quant.calibrate(jnp.asarray(x))
    assert float(s_t) == float(s_j)
    q_t = t_quant.quantize(torch.from_numpy(x), s_t)
    q_j = j_quant.quantize(jnp.asarray(x), s_j)
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(
        t_quant.dequantize(q_t, s_t).numpy(),
        np.asarray(j_quant.dequantize(q_j, s_j)))
    assert torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() == \
        [0.0, 2.0, 2.0, -0.0]


def test_quantize_conv_weights_matches_reference():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 3, 8, 16)).astype(np.float32)
    w *= np.linspace(0.1, 3.0, 16, dtype=np.float32)
    q_t, s_t = t_quant.quantize_conv_weights(torch.from_numpy(w))
    q_j, s_j = j_quant.quantize_conv_weights(jnp.asarray(w))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


# --------------------------------------------------------------------------
# on a card: the kernels against their plain versions
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(100, 200, 60), (1, 2048, 1000),
                                   (43264, 288, 64)])
def test_matmul_kernel_matches_plain_on_card(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=cuda) * 1e-2 + 1e-4
    bias = torch.randn(n, generator=g, device=cuda)
    before = t_cc_kernel.launches
    for td in (torch.float32, torch.bfloat16):
        got = t_cc.matmul_int8(a, b, scale, bias, relu=True, out_dtype=td)
        want = matmul_int8_ref(a, b, scale, bias, relu=True, out_dtype=td)
        torch.cuda.synchronize()
        _assert_close(got.cpu(), want.cpu(), str(td).split(".")[-1])
    assert t_cc_kernel.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["none", "relu", "sigmoid", "tanh"])
def test_postprocess_kernel_matches_plain_on_card(cuda, act):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 31, 30, 64), generator=g, device=cuda)
    scale = torch.rand(64, generator=g, device=cuda) * 4 - 2
    bias = torch.randn(64, generator=g, device=cuda)
    before = t_pp_kernel.launches
    for pool in (1, 2):
        got = t_pp.postprocess(x, scale, bias, act=act, pool=pool,
                               out_dtype=torch.float32)
        want = postprocess_ref(x, scale, bias, act=act, pool=pool,
                               out_dtype=torch.float32)
        torch.cuda.synchronize()
        _assert_close(got.cpu(), want.cpu(), "float32")
    assert t_pp_kernel.launches == before + 2

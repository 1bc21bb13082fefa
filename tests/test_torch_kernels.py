"""The port's kernel ops on the CPU (their plain versions) against the
reference's Pallas ops (interpret mode) and pure-jnp oracles, at the
shapes of tests/test_kernels.py; the kernels themselves against their
plain versions on a card (``gpu`` marker).

Tolerances: int8 x int8 accumulation is exact; the fp32 epilogue and
post-processing agree within rtol = atol = 1e-5 (sigmoid/tanh are
different libm implementations); bf16 outputs within one bf16 ulp."""
from __future__ import annotations

import importlib.util
from pathlib import Path

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
from repro_torch.core.yolov3 import LAYERS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.convcore import kernel as t_cc_kernel  # noqa: E402
from repro_torch.kernels.convcore import ops as t_cc  # noqa: E402
from repro_torch.kernels.convcore.ref import conv2d_int8_ref  # noqa: E402
from repro_torch.kernels.convcore.ref import matmul_int8_ref  # noqa: E402
from repro_torch.kernels.postproc import kernel as t_pp_kernel  # noqa: E402
from repro_torch.kernels.postproc import ops as t_pp  # noqa: E402
from repro_torch.kernels.postproc.ref import postprocess_ref  # noqa: E402

# chip_smoke.py's shape lists, so that the CPU checks the card's cases
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

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


FRAME_CONVS = [l for l in LAYERS if l.kind == "conv"]


def _frame_gemm(layer):
    """(M, K, N) of one frame conv's im2col GEMM."""
    return (layer.out_h * layer.out_w, layer.ksize ** 2 * layer.cin,
            layer.cout)


@pytest.mark.parametrize("layer", FRAME_CONVS, ids=lambda l: f"layer{l.index}")
def test_launch_plan_covers_every_frame_conv(layer):
    """The wrapper pads K only where TMA's 16-byte row stride needs it,
    and the split-K ranges cover K's 128-byte slices exactly, in order,
    none empty, on no more blocks than the H100 has SMs."""
    m, k, n = _frame_gemm(layer)
    plan = t_cc_kernel.launch_plan(m, n, k)
    assert plan.kp % 16 == 0 and 0 <= plan.kp - k < 16
    assert plan.kp == k if k % 16 == 0 else plan.kp > k
    ranges = plan.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_slices
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.k_slices * 128 >= plan.kp > (plan.k_slices - 1) * 128
    n_tiles = -(-n // plan.bn)
    m_tiles = -(-m // 128)
    assert plan.bn in (64, 128) and 1 <= plan.m_blocks <= m_tiles
    assert plan.m_blocks * n_tiles * plan.splits <= t_cc_kernel.H100_SMS
    if plan.splits > 1:   # split only where the tiles leave SMs idle
        assert m_tiles * n_tiles * plan.splits <= t_cc_kernel.H100_SMS
        assert all(hi - lo >= t_cc_kernel.MIN_KPS // 2 for lo, hi in ranges)
    # the plan of the padded product is the same plan
    assert t_cc_kernel.launch_plan(m, n, plan.kp) == plan


def test_launch_plan_pads_only_ragged_k():
    assert [t_cc_kernel.launch_plan(128, 64, k).kp
            for k in (27, 32, 200, 288, 4608)] == [32, 32, 208, 288, 4608]


def test_kernel_target_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header gives every kernel source a new
    library name, so build/kernels/ never serves a stale library."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build._target(tmp_path / "k.cu")
    assert first == _build._target(tmp_path / "k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._target(tmp_path / "k.cu")
    assert second != first and second.parent == first.parent
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target(tmp_path / "k.cu") not in (first, second)
    # the repository's own sources, headers included
    for src in sorted(_build.CSRC.glob("*.cu")):
        assert _build._target(src).name.startswith(f"lib{src.stem}-")
    assert (_build.CSRC / "hopper.cuh").exists()


# --------------------------------------------------------------------------
# postproc
# --------------------------------------------------------------------------
POSTPROC_CASES = [
    (32, 32, 16, "relu", 1),
    (32, 32, 16, "relu", 2),
    (64, 64, 8, "sigmoid", 2),
    (30, 30, 8, "none", 2),     # ragged H/W with pooling
    (31, 29, 8, "tanh", 2),     # ragged, odd
    (16, 16, 128, "tanh", 1),
    (16, 16, 8, "sigmoid", 1),
    (12, 18, 8, "none", 3),
]


@pytest.mark.parametrize("h,w,c,act,pool", POSTPROC_CASES)
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


# the launch plan at every shape above (N = 2) and chip_smoke.py's, each
# at pool 1, 2 and 3 and both input element sizes
PLAN_CASES = sorted({(2, h, w, c, pool, elt)
                     for h, w, c, _, pool in POSTPROC_CASES
                     for elt in (4, 2)}
                    | {(*shape, pool, elt)
                       for shape in SMOKE.POSTPROC_SHAPES
                       for pool in SMOKE.POSTPROC_POOLS for elt in (4, 2)})


@pytest.mark.parametrize("n,h,w,c,pool,elt", PLAN_CASES)
def test_postproc_launch_plan_covers_every_output_once(n, h, w, c, pool, elt):
    """Every kept output lies in exactly one item; an item's input columns
    hold its windows; on the ring path every bulk copy of a 16-byte
    aligned map starts 16-byte aligned and is a multiple of 16 bytes,
    fits its stage, and the ring fits shared memory two blocks an SM; the
    vector path only where a pixel is a multiple of 16 bytes.  Pooling
    what the items' runs carry (as the kernel lays them out in a stage,
    rows ``run`` bytes apart) gives the max-pool."""
    plan = t_pp_kernel.launch_plan(n, h, w, c, pool, elt)
    ho, wo, px = h // pool, w // pool, c * elt
    assert 1 <= plan.grid <= min(plan.items, 2 * t_pp_kernel.H100_SMS)
    assert plan.items == n * ho * plan.spans
    seen = np.zeros((n * ho, wo), np.int64)
    x = np.random.default_rng(n * h + w * c).standard_normal(
        (n, h, w, c)).astype(np.float32)
    flat = x.reshape(-1)
    got = np.full((n * ho, wo, c), np.nan, np.float32)
    for i in range(plan.items):
        band, ow0, cnt, col0, cols = t_pp_kernel.item_extent(plan, w, pool, i)
        assert 1 <= cnt <= plan.span and col0 == ow0 * pool
        assert ow0 + cnt <= wo and cnt * pool <= cols and col0 + cols <= w
        seen[band, ow0:ow0 + cnt] += 1
        nn, oh = divmod(band, ho)
        first = ((nn * h + oh * pool) * w + col0) * c    # elements
        pitch = plan.run // elt if plan.bulk else w * c
        if plan.bulk:
            assert (first * elt) % 16 == 0 and (w * px) % 16 == 0
            assert (cols * px) % 16 == 0 and cols * px <= plan.run
            stage = np.zeros(pool * pitch, np.float32)
            for r in range(pool):
                src = first + r * w * c
                stage[r * pitch:r * pitch + cols * c] = flat[src:src + cols * c]
        else:
            stage = flat[first:]
        win = [stage[i_ * pitch + (ow * pool + j) * c:][:c]
               for ow in range(cnt) for i_ in range(pool)
               for j in range(pool)]
        got[band, ow0:ow0 + cnt] = np.max(
            np.reshape(win, (cnt, pool * pool, c)), axis=1)
    assert (seen == 1).all()
    want = x[:, :ho * pool, :wo * pool].reshape(n, ho, pool, wo, pool, c) \
        .max(axis=(2, 4)).reshape(n * ho, wo, c)
    np.testing.assert_array_equal(got, want)
    if plan.bulk:
        assert plan.run % 16 == 0 and plan.stage % 128 == 0
        assert plan.stage >= pool * plan.run and 2 <= plan.stages <= 4
        assert plan.smem == t_pp_kernel.BAR_BYTES + plan.stages * plan.stage
        assert plan.smem <= 227 * 1024
        assert t_pp_kernel.BLOCKS_PER_SM * (plan.smem + 1024) <= 228 * 1024
        assert plan.vec == (16 // elt if px % 16 == 0 else 1)
    else:
        assert (w * px) % 16 or 2 * plan.stage > t_pp_kernel.SMEM_BUDGET
        assert plan.vec == 1 and plan.smem == 0


def test_postproc_launch_plan_at_the_main_path_shape():
    """The numeric stage's 208 x 208 x 64 fp32 map at pool 2: the ring
    with 16-byte vectors, two blocks on each of 132 SMs, every block's
    items in flight at once."""
    plan = t_pp_kernel.launch_plan(1, 208, 208, 64, 2, 4)
    assert plan.bulk and plan.vec == 4 and plan.grid == 264
    assert plan.items <= plan.grid * plan.stages
    assert plan.stages * plan.stage >= 48 * 1024 // 2
    # ragged rows or pixels that are not a multiple of 16 bytes
    assert not t_pp_kernel.launch_plan(2, 29, 29, 3, 2, 4).bulk
    assert t_pp_kernel.launch_plan(2, 31, 30, 12, 2, 2).vec == 1
    assert t_pp_kernel.launch_plan(2, 0, 8, 8, 2, 4).items == 0


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
                                   (43264, 288, 64), (173056, 27, 32),
                                   (169, 4608, 1024), (676, 512, 255)])
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
@pytest.mark.parametrize("shape", [(2, 31, 30, 64)] + SMOKE.POSTPROC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", ["none", "relu", "sigmoid", "tanh"])
def test_postprocess_kernel_matches_plain_on_card(cuda, act, shape):
    """Every path of the kernel (the ring with vectors or one channel at
    a time, the direct loads), at pool 1, 2 and 3, both input and both
    output dtypes; the kernel's own plan is launch_plan's."""
    g = torch.Generator(device=cuda).manual_seed(1)
    c = shape[-1]
    scale = torch.rand(c, generator=g, device=cuda) * 4 - 2
    bias = torch.randn(c, generator=g, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    before = t_pp_kernel.launches
    for td in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=g, device=cuda).to(td)
        for pool in (1, 2, 3):
            args = (*shape, pool, x.element_size(), sms)
            assert t_pp_kernel.built_plan(*args) == \
                t_pp_kernel.launch_plan(*args)
            for out in (torch.float32, torch.bfloat16):
                got = t_pp.postprocess(x, scale, bias, act=act, pool=pool,
                                       out_dtype=out)
                want = postprocess_ref(x, scale, bias, act=act, pool=pool,
                                       out_dtype=out)
                torch.cuda.synchronize()
                _assert_close(got.cpu(), want.cpu(), str(out).split(".")[-1])
    assert t_pp_kernel.launches == before + 12


@pytest.mark.gpu
def test_postprocess_kernel_takes_an_unaligned_map(cuda):
    """A map whose storage starts off 16-byte alignment is copied once by
    the wrapper and still goes through the kernel."""
    flat = torch.randn(1 + 2 * 16 * 16 * 8, device=cuda)
    x = flat[1:].view(2, 16, 16, 8)
    assert x.data_ptr() % 16
    scale, bias = torch.rand(8, device=cuda), torch.randn(8, device=cuda)
    before = t_pp_kernel.launches
    got = t_pp.postprocess(x, scale, bias, act="relu", pool=2,
                           out_dtype=torch.float32)
    want = postprocess_ref(x, scale, bias, act="relu", pool=2,
                           out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert t_pp_kernel.launches == before + 1
    _assert_close(got.cpu(), want.cpu(), "float32")


@pytest.mark.gpu
@pytest.mark.parametrize("layer", FRAME_CONVS, ids=lambda l: f"layer{l.index}")
def test_matmul_kernel_exact_at_frame_shapes(cuda, layer):
    """int32 accumulation is exact through every launch plan of a frame
    (split-K included): unit scale and zero bias give the exact integer
    product, rounded once to fp32."""
    m, k, n = _frame_gemm(layer)
    g = torch.Generator(device=cuda).manual_seed(layer.index)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    got = t_cc.matmul_int8(a, b, torch.ones(n, device=cuda),
                           torch.zeros(n, device=cuda),
                           out_dtype=torch.float32)
    assert torch.equal(got, (a.double() @ b.double()).float())

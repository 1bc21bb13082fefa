"""The port's SSD intra-chunk op and chunked scan against the reference.

On the CPU the op runs its plain version (``kernels/ssd/ref.py``); it is
held to the reference's Pallas op (interpret mode) and pure-jnp oracle,
and ``models.ssm.ssd_chunked`` to the reference's, at rtol = atol = 1e-4
— the reference's own tolerance for this kernel — with one SSM group
and with several (the op runs once per group over its contiguous
heads).  On a card (``gpu`` marker) the Hopper kernel is held to the
plain version at the same tolerance.  Inputs are made with numpy and
fed to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ssd_intra_chunk as j_intra  # noqa: E402
from repro.kernels.ssd.ref import ssd_intra_chunk_ref as j_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_chunked  # noqa: E402
from repro_torch.kernels.ssd import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd import ssd_intra_chunk  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (bb, l, chunk, h, p, n): test_kernels.py's three shapes, a ragged
# single chunk (q = l = 40, not a multiple of anything), and bb > 2
SHAPES = [
    (2, 64, 32, 4, 16, 32),
    (2, 128, 32, 8, 32, 64),
    (2, 32, 32, 2, 16, 16),      # single chunk
    (1, 40, 32, 3, 16, 24),      # ragged single chunk
    (3, 96, 32, 2, 8, 16),       # bb > 2, three chunks
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bb, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bb, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bb, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = rng.standard_normal((bb, l, n)).astype(np.float32)
    C = rng.standard_normal((bb, l, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("bb,l,chunk,h,p,n", SHAPES)
def test_intra_chunk_matches_reference(bb, l, chunk, h, p, n):
    args = _inputs(bb, l, h, p, n, seed=l + h)
    y, states, cum = ssd_intra_chunk(*map(torch.from_numpy, args),
                                     chunk=chunk)
    jy, jstates, jcum = j_intra(*map(jnp.asarray, args), chunk=chunk,
                                interpret=True)
    q = chunk if l % chunk == 0 and l > chunk else l
    nc = l // q
    assert tuple(y.shape) == (bb, nc, q, h, p)
    assert tuple(states.shape) == (bb, nc, h, n, p)
    np.testing.assert_allclose(cum.numpy(), np.asarray(jcum), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(jstates), **TOL)
    x, dt, _, B, C = args
    ry, rstates = j_ref(x.reshape(bb, nc, q, h, p), dt.reshape(bb, nc, q, h),
                        np.asarray(jcum), B.reshape(bb, nc, q, n),
                        C.reshape(bb, nc, q, n))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(rstates), **TOL)


@pytest.mark.parametrize("bb,l,chunk,h,p,n", SHAPES)
def test_ssd_chunked_matches_reference(bb, l, chunk, h, p, n):
    x, dt, A, B, C = _inputs(bb, l, h, p, n, seed=7 * l + h)
    D = np.random.default_rng(l).standard_normal(h).astype(np.float32)
    B4, C4 = B.reshape(bb, l, 1, n), C.reshape(bb, l, 1, n)
    y, final = ssd_chunked(*map(torch.from_numpy, (x, dt, A, B4, C4, D)),
                           chunk=chunk)
    jy, jfinal = j_chunked(*map(jnp.asarray, (x, dt, A, B4, C4, D)),
                           chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)


def _grouped_inputs(bb, l, h, p, n, g, seed):
    """SSD operands with B/C of G groups: (bb, l, g, n)."""
    rng = np.random.default_rng(seed)
    x, dt, A, _, _ = _inputs(bb, l, h, p, n, seed)
    B = rng.standard_normal((bb, l, g, n)).astype(np.float32)
    C = rng.standard_normal((bb, l, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    return x, dt, A, B, C, D


def test_ssd_chunked_takes_one_group_only():
    """B/C with a group axis: each group serves its contiguous heads (6
    heads in 2 groups of 3, no multiple of the kernel's 4-head tile) and
    the scan gives the reference's grouped einsums; heads that do not
    split into the groups are refused by name."""
    x, dt, A, B, C, D = _grouped_inputs(1, 64, 6, 8, 16, 2, seed=0)
    y, final = ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C, D)),
                           chunk=32)
    jy, jfinal = j_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)
    x5, dt5, A5, _, _ = _inputs(1, 32, 5, 8, 16, seed=0)
    with pytest.raises(ValueError, match="do not split"):
        ssd_intra_chunk(torch.from_numpy(x5), torch.from_numpy(dt5),
                        torch.from_numpy(A5), torch.from_numpy(B[:, :32]),
                        torch.from_numpy(C[:, :32]), chunk=32)


# (bb, l, chunk, h, p, n, g): 2 and 4 groups, h / g of 1, 2, 3 and 6
GROUPED = [
    (2, 64, 32, 4, 16, 32, 2),
    (2, 128, 32, 8, 16, 32, 4),
    (1, 40, 32, 6, 8, 16, 2),       # ragged single chunk, 3 heads a group
    (2, 96, 32, 4, 8, 16, 4),       # one head a group
    (1, 64, 32, 24, 8, 16, 4),      # 6 heads a group
]


@pytest.mark.parametrize("bb,l,chunk,h,p,n,g", GROUPED)
def test_grouped_ssd_chunked_matches_reference(bb, l, chunk, h, p, n, g):
    x, dt, A, B, C, D = _grouped_inputs(bb, l, h, p, n, g, seed=l + h + g)
    y, final = ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C, D)),
                           chunk=chunk)
    jy, jfinal = j_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)),
                           chunk=chunk)
    assert tuple(y.shape) == (bb, l, h, p)
    assert tuple(final.shape) == (bb, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)


@pytest.mark.parametrize("bb,l,chunk,h,p,n,g", GROUPED[:3])
def test_grouped_intra_chunk_is_the_reference_op_per_group(bb, l, chunk, h,
                                                           p, n, g):
    """The grouped op's y_intra, states and cum, head block by head
    block, against the reference's Pallas op (interpret mode) on that
    group's heads and its B/C."""
    x, dt, A, B, C, _ = _grouped_inputs(bb, l, h, p, n, g, seed=3 * l + g)
    y, states, cum = ssd_intra_chunk(*map(torch.from_numpy,
                                          (x, dt, A, B, C)), chunk=chunk)
    hg = h // g
    for gi in range(g):
        heads = slice(gi * hg, (gi + 1) * hg)
        jy, jstates, jcum = j_intra(
            jnp.asarray(x[:, :, heads]), jnp.asarray(dt[:, :, heads]),
            jnp.asarray(A[heads]), jnp.asarray(B[:, :, gi]),
            jnp.asarray(C[:, :, gi]), chunk=chunk, interpret=True)
        np.testing.assert_allclose(y[:, :, :, heads].numpy(),
                                   np.asarray(jy), **TOL)
        np.testing.assert_allclose(states[:, :, heads].numpy(),
                                   np.asarray(jstates), **TOL)
        np.testing.assert_allclose(cum[:, :, :, heads].numpy(),
                                   np.asarray(jcum), **TOL)


def test_intra_chunk_runs_on_cuda_or_cpu_only(monkeypatch):
    """cuda runs the kernel, cpu the plain version; meta tensors (the
    dry-run) only get the outputs' shapes and a cost record, with
    neither run; any other device raises."""
    from repro_torch.kernels import meta

    args = [torch.from_numpy(a).to("meta")
            for a in _inputs(1, 32, 2, 8, 16, seed=0)]
    monkeypatch.setattr(t_ops.ref, "ssd_intra_chunk_ref", None)
    monkeypatch.setattr(t_kernel, "ssd_intra_chunk_kernel", None)
    with meta.recording() as log:
        y, states, cum = ssd_intra_chunk(*args, chunk=16)
    assert (y.shape, states.shape, cum.shape) == (
        (1, 2, 16, 2, 8), (1, 2, 2, 16, 8), (1, 2, 16, 2))
    assert y.device.type == "meta" and [r[0] for r in log] == ["ssd"]
    monkeypatch.setattr(t_ops, "_device_type", lambda t: "mps")
    with pytest.raises(ValueError, match="cuda .* cpu .* or meta"):
        ssd_intra_chunk(*args, chunk=32)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, dt, A, B, C = (torch.from_numpy(a)
                      for a in _inputs(1, 32, 2, 8, 16, seed=0))
    cum = torch.cumsum(dt * A, dim=1)
    before = t_kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        t_kernel.ssd_intra_chunk_kernel(
            x.reshape(1, 1, 32, 2, 8), dt.reshape(1, 1, 32, 2),
            cum.reshape(1, 1, 32, 2), B.reshape(1, 1, 32, 16),
            C.reshape(1, 1, 32, 16))
    assert t_kernel.launches == before


# --------------------------------------------------------------------------
# the tensor-core kernel's rounding points, emulated on the CPU
# --------------------------------------------------------------------------
def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernel's mma.sync products: per k8 step, 3xTF32
    (lo.hi + hi.lo + hi.hi, each operand split as hi = tf32(v), lo =
    tf32(v - hi)) or, for comparison, one TF32 product, summed in fp32;
    the steps' partial sums added in order in fp32."""
    pad = (-a.shape[-1]) % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    acc = None
    for k in range(0, a.shape[-1], 8):
        hi = ahi[..., k:k + 8] @ bhi[..., k:k + 8, :]
        if passes == 3:
            hi = (alo[..., k:k + 8] @ bhi[..., k:k + 8, :]
                  + ahi[..., k:k + 8] @ blo[..., k:k + 8, :]) + hi
        acc = hi if acc is None else acc + hi
    return acc


def _ssd_tensor_cores(x, dt, cum, B, C, passes):
    """ssd.cu's arithmetic: C.B^T from tf32-split products, scores in fp32
    (mask inside the exponent), y = scores @ x and the states B^T (w x)
    from tf32-split products."""
    q = x.shape[2]
    cb = _mm(C, B.transpose(-1, -2), passes)                   # (bb,nc,l,s)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (bb,nc,l,s,h)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    seg = torch.where(causal[None, None, :, :, None], seg,
                      torch.tensor(-1e30))
    scores = cb[..., None] * torch.exp(seg) * dt[:, :, None, :, :]
    y = _mm(scores.permute(0, 1, 4, 2, 3), x.permute(0, 1, 3, 2, 4), passes)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt                # (bb,nc,s,h)
    wx = (x * w[..., None]).permute(0, 1, 3, 2, 4)             # (bb,nc,h,s,p)
    states = _mm(B.transpose(-1, -2)[:, :, None], wx, passes)  # (bb,nc,h,n,p)
    return y.permute(0, 1, 3, 2, 4), states


@pytest.mark.parametrize("bb,l,chunk,h,p,n", [
    (4, 512, 256, 24, 64, 128),   # mamba2-130m full width
    (1, 300, 256, 24, 64, 128),   # a 300-token prompt: one chunk of 300
])
def test_tensor_core_rounding_fits_the_tolerance(bb, l, chunk, h, p, n):
    """The spec ssd.cu keeps in step with: its 3xTF32 products hold the
    plain version within 1e-4 at mamba2-130m's width, where one TF32
    product (about three digits, |y| in the hundreds) does not."""
    args = [torch.from_numpy(a) for a in _inputs(bb, l, h, p, n, seed=l)]
    _, _, _, B, C = args
    plain_y, plain_states, cum = ssd_intra_chunk(*args, chunk=chunk)
    nc, q = cum.shape[1], cum.shape[2]
    x, dt, _, _, _ = args
    ops = (x.reshape(bb, nc, q, h, p), dt.reshape(bb, nc, q, h), cum,
           B.reshape(bb, nc, q, n), C.reshape(bb, nc, q, n))
    assert float(plain_y.abs().max()) > 100
    y3, states3 = _ssd_tensor_cores(*ops, passes=3)
    torch.testing.assert_close(y3, plain_y, **TOL)
    torch.testing.assert_close(states3, plain_states, **TOL)
    y1, states1 = _ssd_tensor_cores(*ops, passes=1)
    assert not torch.allclose(y1, plain_y, **TOL)
    assert float((y1 - plain_y).abs().max()) > \
        10 * float((y3 - plain_y).abs().max())


def test_bf16_logit_gap_is_amplification_through_the_layers():
    """Why the card's bf16 first-token logits through the kernel differ
    from the plain SSD step's by more than LOGITS_TOL (0.151-0.463 in
    chip_smoke.py's serving phase): mamba2-130m at full width (24 layers,
    random weights from seed 0), one bf16 prefill of chip_smoke.py's
    300-token prompt, with the SSD step replaced by the kernel's own
    rounding spec (3xTF32, above).  The spec differs from the plain step
    by about 1e-4 a layer, and so does Gaussian noise of 1.5e-4 on y; both
    move the bf16 logits by the card's order (above 0.05), while in an
    fp32 prefill the spec stays within LOGITS_TOL.  So the gap is the 24
    bf16 layers amplifying the kernel's agreed difference, not a
    departure of the kernel from its spec."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import init_params, prefill
    from repro_torch.types import param_values

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config("mamba2-130m")
    params = param_values(init_params(torch.Generator().manual_seed(0), cfg))
    prompt = smoke.serve_requests(cfg.vocab_size)[1].tokens
    assert len(prompt) == 300
    batch = {"tokens": torch.as_tensor([list(prompt)])}
    plain = ssd_ops.ssd_intra_chunk
    noise = np.random.default_rng(0)

    def spec_step(x, dt, A, B, C, *, chunk):
        xc, dtc, cum, bc, cc = ssd_ops._chunked(x, dt, A, B, C, chunk)
        y, states = _ssd_tensor_cores(xc, dtc, cum, bc, cc, passes=3)
        return y, states, cum

    def noisy_step(*args, chunk):
        y, states, cum = plain(*args, chunk=chunk)
        return y + torch.from_numpy(1.5e-4 * noise.standard_normal(
            y.shape).astype(np.float32)), states, cum

    def logits(step, c):
        ssd_ops.ssd_intra_chunk = step
        try:
            return prefill(params, batch, c, 552)[0][:, :cfg.vocab_size] \
                .float()
        finally:
            ssd_ops.ssd_intra_chunk = plain

    base = logits(plain, cfg)
    spec_gap = float((logits(spec_step, cfg) - base).abs().max())
    noise_gap = float((logits(noisy_step, cfg) - base).abs().max())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    got32, want32 = logits(spec_step, cfg32), logits(plain, cfg32)
    print(f"mamba2-130m first-token logits, 300-token prefill: bf16 "
          f"spec vs plain {spec_gap:.4g}, noise vs plain {noise_gap:.4g}; "
          f"fp32 spec vs plain {float((got32 - want32).abs().max()):.4g}")
    assert spec_gap > 0.05 and noise_gap > 0.05
    assert 0.1 < spec_gap / noise_gap < 10
    torch.testing.assert_close(got32, want32, **smoke.LOGITS_TOL)


# --------------------------------------------------------------------------
# on a card: the kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bb,l,chunk,h,p,n", SHAPES + [
    (4, 512, 256, 24, 64, 128),   # mamba2-130m full width
    (4, 300, 256, 24, 64, 128),   # a 300-token prompt: one chunk of 300
])
def test_kernel_matches_plain_on_card(cuda, bb, l, chunk, h, p, n):
    x, dt, A, B, C = (torch.from_numpy(a).to(cuda)
                      for a in _inputs(bb, l, h, p, n, seed=l))
    before = t_kernel.launches
    y, states, cum = ssd_intra_chunk(x, dt, A, B, C, chunk=chunk)
    nc, q = cum.shape[1], cum.shape[2]
    want_y, want_states = ssd_intra_chunk_ref(
        x.reshape(bb, nc, q, h, p), dt.reshape(bb, nc, q, h), cum,
        B.reshape(bb, nc, q, n), C.reshape(bb, nc, q, n))
    torch.cuda.synchronize()
    assert t_kernel.launches == before + 1
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(states, want_states, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [2, 8])
def test_grouped_kernel_matches_plain_on_card(cuda, g):
    """mamba2-130m's widths (h 24, p 64, n 128, chunk 256) with 2 and 8
    SSM groups: one launch per group over its contiguous heads (12 and
    3 heads), each against the plain version."""
    bb, l, chunk, h, p, n = 2, 512, 256, 24, 64, 128
    x, dt, A, B, C, _ = (torch.from_numpy(a).to(cuda) for a in
                         _grouped_inputs(bb, l, h, p, n, g, seed=g))
    before = t_kernel.launches
    y, states, cum = ssd_intra_chunk(x, dt, A, B, C, chunk=chunk)
    want_y, want_states, want_cum = t_ops.ssd_intra_chunk_plain(
        x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert t_kernel.launches == before + g
    torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(states, want_states, **TOL)

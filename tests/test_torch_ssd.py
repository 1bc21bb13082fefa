"""The port's SSD intra-chunk op and chunked scan against the reference.

On the CPU the op runs its plain version (``kernels/ssd/ref.py``); it is
held to the reference's Pallas op (interpret mode) and pure-jnp oracle,
and ``models.ssm.ssd_chunked`` to the reference's, at rtol = atol = 1e-4
— the reference's own tolerance for this kernel.  On a card (``gpu``
marker) the Hopper kernel is held to the plain version at the same
tolerance.  Inputs are made with numpy and fed to both packages."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd import ssd_intra_chunk as j_intra  # noqa: E402
from repro.kernels.ssd.ref import ssd_intra_chunk_ref as j_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_chunked  # noqa: E402
from repro_torch.kernels.ssd import kernel as t_kernel  # noqa: E402
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


def test_ssd_chunked_takes_one_group_only():
    x, dt, A, B, C = _inputs(1, 32, 2, 8, 16, seed=0)
    B2 = torch.from_numpy(B.reshape(1, 32, 2, 8))
    with pytest.raises(NotImplementedError, match="one group"):
        ssd_chunked(torch.from_numpy(x), torch.from_numpy(dt),
                    torch.from_numpy(A), B2, B2, torch.ones(2), chunk=32)
    with pytest.raises(ValueError, match="single-group"):
        ssd_intra_chunk(torch.from_numpy(x), torch.from_numpy(dt),
                        torch.from_numpy(A), B2, B2, chunk=32)


def test_intra_chunk_runs_on_cuda_or_cpu_only():
    args = [torch.from_numpy(a).to("meta")
            for a in _inputs(1, 32, 2, 8, 16, seed=0)]
    with pytest.raises(ValueError, match="cuda .* or cpu"):
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

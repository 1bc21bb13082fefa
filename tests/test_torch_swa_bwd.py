"""The backward pass of the port's sliding-window attention.

``swa_attention_bwd_plain`` (recompute per query chunk: P from the
scores, dP = dO Vᵀ, dS = P (dP - rowsum(dO O)), times 1 - tanh² with a
softcap) is held to autograd of ``swa_attention_plain`` and to
``jax.vjp`` of the reference's attention oracle (GQA expanded as the
reference's op expands it), in fp32 and bf16, banded, full causal,
soft-capped, grouped and at a ragged S.  A tile-level emulation of the
two CUDA kernels' loops (``csrc/swa_bwd.cu``: the dq grid's two walks
over its band of key tiles, the dkdv grid's walk over the query tiles
whose band meets its key tile, for every query head of the group) is
held to the plain backward at both tile heights the kernels use — the
CPU check of their loop bounds and masks.  On a card (``gpu``) the
kernels are held to the plain backward through the autograd Function.

Tolerances, relative to max|grad| of each gradient: 1e-4 in fp32
(summation order only), 2e-2 in bf16 (the gradients' final bf16
rounding and, against autograd, delta from the bf16 output)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.swa.ref import swa_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.swa import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.swa import ops as t_ops  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (b, s, hq, hkv, d, window, softcap): banded, full causal (window = S),
# ragged S with a band, GQA groups of 2 and 3, MHA, softcap, a band
# wider than S
CASES = [(2, 96, 4, 2, 32, 32, 0.0), (1, 128, 4, 2, 16, 128, 0.0),
         (2, 70, 6, 2, 16, 24, 0.0), (1, 64, 2, 2, 32, 64, 30.0),
         (1, 100, 4, 1, 16, 40, 5.0), (1, 50, 2, 1, 16, 4096, 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, hq, hkv, d, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d))]
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrs]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _close(got, want, dtype, what=""):
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        assert _rel(g, w) <= TOL[dtype], (what, name, _rel(g, w))


def _plain_grads(q, k, v, do, window, softcap):
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        o = t_ops.swa_attention_plain(qs, ks, vs, window=window,
                                      softcap=softcap, block=32)
        return o.detach(), torch.autograd.grad(o, (qs, ks, vs), do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd(case, dtype):
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _inputs(b, s, hq, hkv, d, 0, dtype)
    o, want = _plain_grads(q, k, v, do, window, cap)
    got = t_ops.swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                        softcap=cap, block=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_reference_vjp(case):
    """fp32, against jax.vjp of the reference's oracle with the KV heads
    repeated over their groups (the reference op's GQA) — the repeat's
    transpose sums each group's dK/dV."""
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _inputs(b, s, hq, hkv, d, 1)
    g = hq // hkv

    def j_attn(q, k, v):
        k, v = (jnp.repeat(x, g, axis=2) for x in (k, v))
        bh = [x.transpose(0, 2, 1, 3).reshape(b * hq, s, d)
              for x in (q, k, v)]
        o = j_ref(*bh, window=window, softcap=cap)
        return o.reshape(b, hq, s, d).transpose(0, 2, 1, 3)

    o, vjp = jax.vjp(j_attn, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(x)) for x in vjp(
        jnp.asarray(do.numpy()))]
    got = t_ops.swa_attention_bwd_plain(
        q, k, v, torch.from_numpy(np.array(o)), do, window=window,
        softcap=cap, block=32)
    _close(got, want, torch.float32)


def _emulate_kernels(q, k, v, o, do, window, scale, softcap, br):
    """The two backward grids of csrc/swa_bwd.cu at tile granularity:
    the same tile loops, bounds, masks and two-walk log-sum-exp, fp32."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q, k, v, o, do = (t.to(torch.float32) for t in (q, k, v, o, do))
    pos = torch.arange(s)
    lse = torch.zeros(b, hq, s)
    delta = torch.zeros(b, hq, s)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)

    def capped(u):
        x = u * scale
        if softcap > 0:
            t = torch.tanh(x / softcap)
            return softcap * t, 1 - t * t
        return x, torch.ones_like(x)

    def band(rows, keys):
        qp, kp = rows[:, None], keys[None, :]
        return (kp <= qp) & (qp - kp < window) & (kp < s) & (qp < s)

    def tile(x, r0):        # rows [r0, r0 + br), zero past S
        out = torch.zeros(br, x.shape[-1])
        n = max(0, min(br, s - r0))
        out[:n] = x[r0:r0 + n]
        return out

    for bi in range(b):
        for h in range(hq):
            hk = h // g
            for row0 in range(0, s, br):
                rows = row0 + torch.arange(br)
                qt, dot = tile(q[bi, :, h], row0), tile(do[bi, :, h], row0)
                dlt = (tile(o[bi, :, h], row0) * dot).sum(-1)
                row_hi = min(row0 + br, s)
                c_first = max(0, row0 - window + 1) // br * br
                m = torch.full((br,), -1e30)
                l = torch.zeros(br)
                for c0 in range(c_first, row_hi, br):
                    keys = c0 + torch.arange(br)
                    c, _ = capped(qt @ tile(k[bi, :, hk], c0).T)
                    inb = band(rows, keys)
                    c = torch.where(inb, c, -1e30)
                    m_new = torch.maximum(m, c.max(-1).values)
                    psum = torch.where(inb, torch.exp(c - m_new[:, None]),
                                       0.0).sum(-1)
                    l = l * torch.exp(m - m_new) + psum
                    m = m_new
                lse_t = m + torch.log(l.clamp_min(1e-30))
                n = row_hi - row0
                lse[bi, h, row0:row_hi] = lse_t[:n]
                delta[bi, h, row0:row_hi] = dlt[:n]
                acc = torch.zeros(br, d)
                for c0 in range(c_first, row_hi, br):
                    keys = c0 + torch.arange(br)
                    kt, vt = tile(k[bi, :, hk], c0), tile(v[bi, :, hk], c0)
                    c, slope = capped(qt @ kt.T)
                    p = torch.where(band(rows, keys),
                                    torch.exp(c - lse_t[:, None]), 0.0)
                    acc += (p * (dot @ vt.T - dlt[:, None]) * slope) @ kt
                dq[bi, row0:row_hi, h] = (acc * scale)[:n]
        for hk in range(hkv):
            for c0 in range(0, s, br):
                keys = c0 + torch.arange(br)
                kt, vt = tile(k[bi, :, hk], c0), tile(v[bi, :, hk], c0)
                dk_acc, dv_acc = torch.zeros(br, d), torch.zeros(br, d)
                r_hi = min(s, c0 + br - 1 + window)
                for h in range(hk * g, hk * g + g):
                    for r0 in range(c0, r_hi, br):
                        rows = r0 + torch.arange(br)
                        qt = tile(q[bi, :, h], r0)
                        dot = tile(do[bi, :, h], r0)
                        ls = tile(lse[bi, h][:, None], r0)[:, 0]
                        dl = tile(delta[bi, h][:, None], r0)[:, 0]
                        c, slope = capped(kt @ qt.T)          # (key, row)
                        p = torch.where(band(rows, keys).T,
                                        torch.exp(c - ls[None, :]), 0.0)
                        ds = p * (vt @ dot.T - dl[None, :]) * slope
                        dv_acc += p @ dot
                        dk_acc += ds @ qt
                n = min(br, s - c0)
                dk[bi, c0:c0 + n, hk] = (dk_acc * scale)[:n]
                dv[bi, c0:c0 + n, hk] = dv_acc[:n]
    return dq, dk, dv


@pytest.mark.parametrize("br", [64, 32])
@pytest.mark.parametrize("case", CASES)
def test_kernel_tiling_matches_plain_backward(case, br):
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _inputs(b, s, hq, hkv, d, 2)
    o = t_ops.swa_attention_plain(q, k, v, window=window, softcap=cap)
    want = t_ops.swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                         softcap=cap)
    got = _emulate_kernels(q, k, v, o, do, window, d ** -0.5, cap, br)
    _close(got, want, torch.float32)


def test_swa_attention_is_differentiable_through_its_function():
    """With an operand that needs a gradient the op runs as its autograd
    Function (saving q, k, v, o; the plain backward on the CPU); the
    backward is not differentiable again, so nothing returns a result
    detached from its inputs.  Without gradients no graph is kept."""
    q, k, v, do = _inputs(1, 40, 2, 1, 16, 3)
    q.requires_grad_()
    o = t_ops.swa_attention(q, k, v, window=16)
    assert type(o.grad_fn).__name__ == "_SwaAttentionBackward"
    (gq,) = torch.autograd.grad(o, q, do, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gq.sum(), q)
    with torch.no_grad():
        assert t_ops.swa_attention(q, k, v, window=16).grad_fn is None


def test_ssd_refuses_a_gradient_on_the_card(monkeypatch):
    """The ssd kernel has no backward yet: asked for a gradient on a
    CUDA tensor, ``ssd_intra_chunk`` raises naming ROADMAP's item
    instead of returning a detached result (here the device check is
    made to answer "cuda" for CPU tensors)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 2, 4), np.float32))
    dt = torch.from_numpy(rng.random((1, 8, 2), np.float32))
    a = -torch.ones(2)
    bc = torch.from_numpy(rng.standard_normal((1, 8, 4), np.float32))
    monkeypatch.setattr(ssd_ops, "_device_type", lambda t: "cuda")
    with pytest.raises(NotImplementedError, match="ssd backward"):
        ssd_ops.ssd_intra_chunk(x.requires_grad_(), dt, a, bc, bc, chunk=4)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


GPU_CASES = CASES + [(2, 200, 4, 2, dim, 50, 0.0)
                     for dim in t_kernel.HEAD_DIMS] \
    + [(1, 1030, 14, 2, 64, 1030, 0.0), (1, 300, 16, 1, 256, 128, 30.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernels_match_plain_backward_on_card(case, dtype):
    dev = _card()
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = _inputs(b, s, hq, hkv, d, 5, dtype, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = t_kernel.bwd_launches
    o = t_ops.swa_attention(*leaves, window=window, softcap=cap)
    got = torch.autograd.grad(o, leaves, do)
    assert t_kernel.bwd_launches == before + 1
    want = t_ops.swa_attention_bwd_plain(q, k, v, o.detach(), do,
                                         window=window, softcap=cap)
    _close(got, want, dtype, case)


@pytest.mark.gpu
def test_ssd_refuses_a_gradient_on_card():
    dev = _card()
    x = torch.randn(1, 8, 2, 4, device=dev, requires_grad=True)
    dt = torch.rand(1, 8, 2, device=dev)
    bc = torch.randn(1, 8, 4, device=dev)
    with pytest.raises(NotImplementedError, match="ssd backward"):
        ssd_ops.ssd_intra_chunk(x, dt, -torch.ones(2, device=dev), bc, bc,
                                chunk=4)

"""The backward pass of the port's sliding-window attention.

``swa_attention_bwd_plain`` (recompute per query chunk: P from the
scores, dP = dO Vᵀ, dS = P (dP - rowsum(dO O)), times 1 - tanh² with a
softcap) is held to autograd of ``swa_attention_plain`` and to
``jax.vjp`` of the reference's attention oracle (GQA expanded as the
reference's op expands it), in fp32 and bf16, banded, full causal,
soft-capped, grouped and at a ragged S.  Tile-level emulations of both
routes of ``csrc/swa_bwd.cu`` are held to the plain backward — the CPU
check of their loop bounds, masks and rounding points: the FMA grids
(the dq grid's two walks over its band of key tiles, the dkdv grid's
walk over the query tiles whose band meets its key tile, for every
query head of the group) at both tile heights they use, in fp32; the
tensor-core grids (the forward's log-sum-exp, 128-row blocks of two
64-row warpgroups, the dkdv grid split over the group's query heads and
reduced in head order, bf16 rounding where the kernels round) at 2e-2.
On a card (``gpu``) the kernels are held to the plain backward through
the autograd Function, and two launches must be bit-equal.

Tolerances, relative to max|grad| of each gradient: 1e-4 in fp32
(summation order only), 2e-2 in bf16 (bf16 operands, P and dS rounded
to bf16 before their products, the gradients' final rounding and,
against autograd, delta from the bf16 output)."""
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


def _emulate_tc_kernels(q, k, v, o, do, window, scale, softcap):
    """The tensor-core route of csrc/swa_bwd.cu at tile granularity, from
    the forward's log-sum-exp (swa.cu's ``swa_tc_kernel``: an online
    softmax in log2 units over each 64-row tile's band of 64-key tiles,
    written as a natural log): ``swa_bwd_tc_dq``'s blocks of 128 rows (two
    64-row warpgroups) over the union of their bands' key tiles, with
    the mask only on tiles that are not interior, the rows' (lse2,
    delta) kept in scratch padded to 64 rows; ``swa_bwd_tc_dkdv``'s
    blocks of 128 keys of one query head over the query tiles from the
    block's diagonal to the band's far edge; ``swa_bwd_reduce``'s sum of
    each group's fp32 shares in head order.  bf16 operands, fp32
    products and accumulators, P^T and dS (dS^T) rounded to bf16 before
    their products, each gradient rounded to bf16 once."""
    def rnd(t):
        return t.to(torch.bfloat16).to(torch.float32)

    log2e, ln2, rows = 1.4426950408889634, 0.6931471805599453, 64
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q, k, v, o, do = (rnd(t) for t in (q, k, v, o, do))
    sp = -(-s // rows) * rows
    blocks = -(-s // (2 * rows))
    ar = torch.arange(rows)

    def xform(u):            # capped score in log2 units, and its slope
        if softcap > 0:
            t = torch.tanh(u * (scale / softcap))
            return softcap * log2e * t, 1 - t * t
        return u * (scale * log2e), torch.ones_like(u)

    def tile(x, r0):         # rows [r0, r0 + 64) of (S, D), zero past S
        out = torch.zeros(rows, x.shape[-1])
        n = max(0, min(rows, s - r0))
        out[:n] = x[r0:r0 + n]
        return out

    def band(qpos, kpos):    # (rows, keys) in the band
        return (kpos[None, :] <= qpos[:, None]) \
            & (qpos[:, None] - kpos[None, :] < window)

    # the forward's lse, then the dq grid's stats: (lse2, delta), rows
    # from S to SP zero
    lse2 = torch.zeros(b, hq, sp)
    delta = torch.zeros(b, hq, sp)
    for bi in range(b):
        for h in range(hq):
            hk = h // g
            for r0 in range(0, s, rows):
                qt = tile(q[bi, :, h], r0)
                m = torch.full((rows,), -torch.inf)
                l = torch.zeros(rows)
                for c0 in range(max(0, r0 - window + 1) // rows * rows,
                                min(r0 + rows, s), rows):
                    x, _ = xform(qt @ tile(k[bi, :, hk], c0).T)
                    x = torch.where(band(r0 + ar, c0 + ar), x, -torch.inf)
                    m_new = torch.maximum(m, x.max(-1).values)
                    base = torch.where(m_new == -torch.inf, 0.0, m_new)
                    l = l * torch.exp2(m - base) \
                        + torch.exp2(x - base[:, None]).sum(-1)
                    m = m_new
                n = min(rows, s - r0)
                lse = (m + torch.log2(l.clamp_min(1e-30))) * ln2
                lse2[bi, h, r0:r0 + n] = (lse * log2e)[:n]
                delta[bi, h, r0:r0 + n] = (tile(o[bi, :, h], r0) * tile(
                    do[bi, :, h], r0)).sum(-1)[:n]

    def step_ok(own, other, own_is_key):
        """own (64 rows of the warpgroup) meets the streamed tile, and
        whether the pair tile is interior (no mask)"""
        key0, row0 = (own, other) if own_is_key else (other, own)
        meets = key0 <= row0 + rows - 1 and row0 - (key0 + rows - 1) < window
        interior = key0 + rows - 1 <= row0 and row0 + rows - 1 - key0 < window
        return meets, interior

    dq = torch.zeros_like(q)
    part = torch.zeros(2, b, s, hq, d)
    for bi in range(b):
        for h in range(hq):
            hk = h // g
            for blk in range(blocks):
                # swa_bwd_tc_dq: rows [row0, row0 + 128)
                row0 = blk * 2 * rows
                t_lo = max(0, row0 - window + 1) // rows
                ntiles = (min(row0 + 2 * rows, s) - 1) // rows - t_lo + 1
                for wg in range(2):
                    r0 = row0 + wg * rows
                    if r0 >= s:
                        continue
                    qt, dot = tile(q[bi, :, h], r0), tile(do[bi, :, h], r0)
                    l2, dl = lse2[bi, h, r0:r0 + rows], delta[bi, h, r0:r0 + rows]
                    acc = torch.zeros(rows, d)
                    for t in range(ntiles):
                        c0 = (t_lo + t) * rows
                        meets, interior = step_ok(r0, c0, False)
                        if not meets:
                            continue
                        kt, vt = tile(k[bi, :, hk], c0), tile(v[bi, :, hk], c0)
                        x, slope = xform(qt @ kt.T)
                        p = torch.exp2(x - l2[:, None])
                        if not interior:
                            p = torch.where(band(r0 + ar, c0 + ar), p, 0.0)
                        ds = p * (dot @ vt.T - dl[:, None]) * slope
                        acc += rnd(ds) @ kt
                    n = min(rows, s - r0)
                    dq[bi, r0:r0 + n, h] = rnd(acc * scale)[:n]
                # swa_bwd_tc_dkdv: keys [k0, k0 + 128) of this query head
                k0 = blk * 2 * rows
                t_lo = k0 // rows
                ntiles = (min(s, k0 + 2 * rows - 1 + window) - 1) // rows \
                    - t_lo + 1
                for wg in range(2):
                    c0 = k0 + wg * rows
                    if c0 >= s:
                        continue
                    kt, vt = tile(k[bi, :, hk], c0), tile(v[bi, :, hk], c0)
                    dk_acc, dv_acc = torch.zeros(rows, d), torch.zeros(rows, d)
                    for t in range(ntiles):
                        r0 = (t_lo + t) * rows
                        meets, interior = step_ok(c0, r0, True)
                        interior = interior and r0 + rows - 1 < s
                        if not meets:
                            continue
                        assert r0 + rows <= sp
                        qt, dot = tile(q[bi, :, h], r0), tile(do[bi, :, h], r0)
                        l2, dl = lse2[bi, h, r0:r0 + rows], delta[bi, h, r0:r0 + rows]
                        x, slope = xform(kt @ qt.T)          # (key, row)
                        pt = torch.exp2(x - l2[None, :])
                        if not interior:
                            keep = band(r0 + ar, c0 + ar).T & (r0 + ar < s)[None, :]
                            pt = torch.where(keep, pt, 0.0)
                        dst = pt * (vt @ dot.T - dl[None, :]) * slope
                        dv_acc += rnd(pt) @ dot
                        dk_acc += rnd(dst) @ qt
                    n = min(rows, s - c0)
                    part[0, bi, c0:c0 + n, h] = dk_acc[:n]
                    part[1, bi, c0:c0 + n, h] = dv_acc[:n]
    # swa_bwd_reduce: each group's shares in head order
    part = part.reshape(2, b, s, hkv, g, d)
    total = part[..., 0, :]
    for j in range(1, g):
        total = total + part[..., j, :]
    return dq, rnd(total[0] * scale), rnd(total[1])


# (b, s, hq, hkv, d, window, softcap): qwen2-0.5b's heads (14 over 2, D
# 64) full causal, a D 128 GQA group of 4 at a ragged S, a band narrower
# than S at a ragged S, grok-1's softcap of 30 with its groups of 6 over a
# band, one KV head at D 16
TC_CASES = [(1, 192, 14, 2, 64, 192, 0.0), (1, 130, 8, 2, 128, 130, 0.0),
            (2, 200, 4, 2, 32, 50, 0.0), (1, 160, 12, 2, 64, 96, 30.0),
            (1, 100, 3, 1, 16, 40, 0.0)]


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_tiling_matches_plain_backward(case):
    b, s, hq, hkv, d, window, cap = case
    q, k, v, do = (t.to(torch.bfloat16).to(torch.float32)
                   for t in _inputs(b, s, hq, hkv, d, 7))
    o = t_ops.swa_attention_plain(q, k, v, window=window, softcap=cap)
    want = t_ops.swa_attention_bwd_plain(q, k, v, o, do, window=window,
                                         softcap=cap)
    got = _emulate_tc_kernels(q, k, v, o, do, window, d ** -0.5, cap)
    for name, x, w in zip("qkv", got, want):
        assert _rel(x, w) <= TOL[torch.bfloat16], (case, name, _rel(x, w))


def test_backward_route_is_a_rule_by_dtype_and_head_dim():
    """bf16 at D <= 128 on the tensor cores; fp32 (the 1e-4 tolerance) and
    bf16 at D 256 (dK and dV do not fit a warpgroup's registers) on the
    FMA grids."""
    assert [t_kernel.bwd_route(torch.bfloat16, d)
            for d in t_kernel.HEAD_DIMS] == ["tc"] * 4 + ["fma"]
    assert {t_kernel.bwd_route(torch.float32, d)
            for d in t_kernel.HEAD_DIMS} == {"fma"}


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


def test_ssd_gradient_goes_through_the_backward_kernel_on_cuda_tensors(
        monkeypatch):
    """On a CUDA tensor that needs a gradient ``ssd_intra_chunk``
    refuses the plain versions (set to None here) and hands the
    backward to the ssd backward kernel (here the device check is made
    to answer "cuda" for CPU tensors, and the kernels' wrappers are
    counting stand-ins over the plain versions): one forward and one
    backward launch, and the gradients of the plain op."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ref as ssd_ref

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 2, 4), np.float32))
    dt = torch.from_numpy(rng.random((1, 8, 2), np.float32))
    a = -torch.ones(2)
    bc = torch.from_numpy(rng.standard_normal((1, 8, 4), np.float32))
    leaf = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(ssd_ops.ssd_intra_chunk_plain(
        leaf, dt, a, bc, bc, chunk=4)[0].sum(), leaf)
    calls = {"fwd": 0, "bwd": 0}
    plain_fwd, plain_bwd = ssd_ref.ssd_intra_chunk_ref, \
        ssd_ref.ssd_intra_chunk_bwd_ref

    def fwd(*args):
        calls["fwd"] += 1
        return plain_fwd(*args)

    def bwd(*args):
        calls["bwd"] += 1
        return plain_bwd(*args)

    monkeypatch.setattr(ssd_ops, "_device_type", lambda t: "cuda")
    monkeypatch.setattr(ssd_kernel, "ssd_intra_chunk_kernel", fwd)
    monkeypatch.setattr(ssd_kernel, "ssd_intra_chunk_bwd_kernel", bwd)
    monkeypatch.setattr(ssd_ref, "ssd_intra_chunk_ref", None)
    monkeypatch.setattr(ssd_ref, "ssd_intra_chunk_bwd_ref", None)
    leaf = x.clone().requires_grad_()
    (got,) = torch.autograd.grad(ssd_ops.ssd_intra_chunk(
        leaf, dt, a, bc, bc, chunk=4)[0].sum(), leaf)
    assert calls == {"fwd": 1, "bwd": 1}
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_is_deterministic_on_card(dtype):
    """No atomics: two launches on the same inputs are bit-equal, at
    qwen2-0.5b's training shape (the tensor-core route in bf16)."""
    dev = _card()
    b, s, hq, hkv, d = 4, 1024, 14, 2, 64
    q, k, v, do = _inputs(b, s, hq, hkv, d, 8, dtype, dev)
    scale = d ** -0.5
    if t_kernel.bwd_route(dtype, d) == "tc":
        o, lse = t_kernel.swa_attention_kernel(q, k, v, window=s, scale=scale,
                                               with_lse=True)
    else:
        o, lse = t_kernel.swa_attention_kernel(q, k, v, window=s,
                                               scale=scale), None
    first, second = (t_kernel.swa_attention_bwd_kernel(
        q, k, v, o, do, window=s, scale=scale, lse=lse) for _ in range(2))
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_ssd_gradient_goes_through_the_backward_kernel_on_card():
    """On the card the op's gradient goes through the ssd backward
    kernel (one launch) and not the plain backward, within 1e-4 of
    max|g| of the plain op's."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    dev = _card()
    x = torch.randn(1, 8, 2, 4, device=dev, requires_grad=True)
    dt = torch.rand(1, 8, 2, device=dev)
    bc = torch.randn(1, 8, 4, device=dev)
    a = -torch.ones(2, device=dev)
    before = ssd_kernel.bwd_launches
    (got,) = torch.autograd.grad(ssd_ops.ssd_intra_chunk(
        x, dt, a, bc, bc, chunk=4)[0].sum(), x)
    assert ssd_kernel.bwd_launches == before + 1
    (want,) = torch.autograd.grad(ssd_ops.ssd_intra_chunk_plain(
        x, dt, a, bc, bc, chunk=4)[0].sum(), x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())

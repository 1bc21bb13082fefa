"""The backward pass of the port's SSD intra-chunk step.

``ssd_intra_chunk_bwd_ref`` (the closed form of the five gradients gx,
gdt, gcum, gB, gC given the cotangents of y and the chunk states) is
held to ``jax.vjp`` of the reference's SSD oracle, and the op's autograd
Function (which adds the gradients of dt and A through cum = cumsum(dt
A), the chunking and the per-group slices) to ``jax.grad`` of the
reference's ``ssd_chunked`` with one and with two SSM groups, in fp32
at 1e-5 of each gradient's max|g| (summation order only).  A tile-level
emulation of ``csrc/ssd_bwd.cu`` — its 3xTF32 products with a fp32
partial sum a k8 step, the tiles each grid walks, the partial sums it
writes and the order the reduce adds them in — is held to the plain
backward in float64 at 1e-4 of max|g|, the bar the kernel is held to on
the card, which one TF32 product a step misses.  On a card (``gpu``)
the kernels are held to the plain backward in float64, two launches must
be bit-equal, and a mamba2 training step through the kernels is held to
the same step through the plain versions."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd.ref import ssd_intra_chunk_ref as j_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as j_chunked  # noqa: E402
from repro_torch.kernels.ssd import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as t_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

REF_TOL = 1e-5     # fp32 against the reference, relative to max|g|
KERNEL_TOL = 1e-4  # the kernel's bar against float64 (the forward's own)
NAMES = ("gx", "gdt", "gcum", "gB", "gC")

# (bb, l, chunk, h, p, n): test_kernels.py's shapes, a ragged single
# chunk and three chunks
SHAPES = [(2, 64, 32, 4, 16, 32), (2, 128, 32, 8, 32, 64),
          (2, 32, 32, 2, 16, 16), (1, 40, 32, 3, 16, 24),
          (3, 96, 32, 2, 8, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(bb, l, h, p, n, seed, g=0):
    """x, post-softplus dt, negative A, B, C (grouped (bb, l, g, n) when
    ``g``), as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bb, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bb, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bshape = (bb, l, g, n) if g else (bb, l, n)
    B = rng.standard_normal(bshape).astype(np.float32)
    C = rng.standard_normal(bshape).astype(np.float32)
    return x, dt, A, B, C


def _chunk_operands(bb, l, chunk, h, p, n, seed):
    """The kernel's operands (x, dt, cum, B, C, gy, gst) chunked, as
    numpy float32, with seeded cotangents."""
    x, dt, A, B, C = _inputs(bb, l, h, p, n, seed)
    q = chunk if l % chunk == 0 and l > chunk else l
    nc = l // q
    dtc = dt.reshape(bb, nc, q, h)
    cum = np.cumsum(dtc * A, axis=2, dtype=np.float32)
    rng = np.random.default_rng(seed + 1)
    gy = rng.standard_normal((bb, nc, q, h, p)).astype(np.float32)
    gst = rng.standard_normal((bb, nc, h, n, p)).astype(np.float32)
    return (x.reshape(bb, nc, q, h, p), dtc, cum, B.reshape(bb, nc, q, n),
            C.reshape(bb, nc, q, n), gy, gst)


def _rel(got, want) -> float:
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# --------------------------------------------------------------------------
# the plain backward and the op against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bb,l,chunk,h,p,n", SHAPES)
def test_plain_backward_matches_reference_vjp(bb, l, chunk, h, p, n):
    ops_np = _chunk_operands(bb, l, chunk, h, p, n, seed=l + h)
    _, vjp = jax.vjp(j_ref, *map(jnp.asarray, ops_np[:5]))
    want = vjp((jnp.asarray(ops_np[5]), jnp.asarray(ops_np[6])))
    got = t_ref.ssd_intra_chunk_bwd_ref(*map(torch.from_numpy, ops_np))
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32
        assert _rel(a.numpy(), w) <= REF_TOL, (name, _rel(a.numpy(), w))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("bb,l,chunk,h,p,n", [(2, 96, 32, 4, 16, 24),
                                              (1, 40, 32, 6, 8, 16)])
def test_op_gradients_match_reference_grad(bb, l, chunk, h, p, n, g):
    """Through ``models.ssm.ssd_chunked``: the autograd Function's
    gradients, with the chunking, the cumsum of dt A, the per-group slices,
    the inter-chunk scan and the D skip, against ``jax.grad`` of the
    reference's; the final state's cotangent is nonzero, so the last
    chunk's states carry a gradient too."""
    x, dt, A, B, C = _inputs(bb, l, h, p, n, seed=3 * l + g, g=g)
    rng = np.random.default_rng(l)
    D = rng.standard_normal(h).astype(np.float32)
    gy = rng.standard_normal((bb, l, h, p)).astype(np.float32)
    gf = rng.standard_normal((bb, h, n, p)).astype(np.float32)
    args = (x, dt, A, B, C, D)

    def j_loss(*a):
        y, final = j_chunked(*a, chunk=chunk)
        return (y * gy).sum() + (final * gf).sum()

    want = jax.grad(j_loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, final = ssd_chunked(*leaves, chunk=chunk)
    assert y.grad_fn is not None
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (final * torch.from_numpy(gf)).sum(),
        leaves)
    for name, a, w in zip("x dt A B C D".split(), got, want):
        assert _rel(a.numpy(), w) <= REF_TOL, (name, _rel(a.numpy(), w))


def test_op_is_differentiable_once_through_its_function():
    """With an operand that needs a gradient each group's call runs as
    the autograd Function (the plain backward on the CPU); its backward
    is not differentiable again, so no result is returned detached from
    its inputs.  Without gradients no graph is kept."""
    x, dt, A, B, C = map(torch.from_numpy, _inputs(1, 64, 2, 8, 16, seed=5))
    x.requires_grad_()
    y, states, cum = t_ops.ssd_intra_chunk(x, dt, A, B, C, chunk=32)
    assert type(y.grad_fn).__name__ == "_SsdIntraChunkBackward"
    (gx,) = torch.autograd.grad(y.sum() + states.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), x)
    with torch.no_grad():
        assert t_ops.ssd_intra_chunk(x, dt, A, B, C, chunk=32)[0].grad_fn \
            is None


# --------------------------------------------------------------------------
# the kernels' tiles, products and summation order, emulated on the CPU
# --------------------------------------------------------------------------
TILE = 64


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x):
    """What the tensor cores read of an fp32 word as tf32: its top 19
    bits (the mantissa truncated to 10 bits)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mma(acc, a, b, passes):
    """acc + a @ b as tf32_tc.cuh's products: per k8 step 3xTF32 (lo.hi +
    hi.lo, then + hi.hi) or one TF32 product into a fresh fp32 partial
    sum, each step's partial added to acc in fp32, in k order; hi is the
    fp32 operand as the tensor cores read it (truncated to tf32), lo =
    tf32(x - hi) rounded to nearest."""
    ahi, bhi = _trunc_tf32(a), _trunc_tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        part = ahi[..., ks] @ bhi[..., ks, :]
        if passes == 3:
            part = (alo[..., ks] @ bhi[..., ks, :]
                    + ahi[..., ks] @ blo[..., ks, :]) + part
        acc = part if acc is None else acc + part
    return acc


def _emulate_bwd_kernels(x, dt, cum, B, C, gy, gst, passes=3):
    """ssd_bwd.cu's five grids on fp32 operands (x/gy (bb, nc, q, h, p),
    dt/cum (bb, nc, q, h), B/C (bb, nc, q, n), gst (bb, nc, h, n, p)),
    tile by tile: q padded with zeros to whole 64-row tiles, p to 64 and
    n to whole 64-column halves, every product a 64-deep stage of k8
    steps (``_mma``)."""
    bb, nc, q, h, p = x.shape
    n = B.shape[-1]
    plan = t_kernel.bwd_plan(bb * nc, q, h, p, n)
    tiles, qp, groups = plan["tiles"], plan["qp"], plan["groups"]
    hg = t_kernel.BWD_HEAD_GROUP
    pp, np_ = TILE, plan["halves"] * TILE

    def pad(t, dims):
        return torch.nn.functional.pad(t, [v for d in reversed(dims)
                                           for v in (0, d)])

    xh = pad(x, (0, 0, qp - q, 0, pp - p)).permute(0, 1, 3, 2, 4)  # b c h q p
    gyh = pad(gy, (0, 0, qp - q, 0, pp - p)).permute(0, 1, 3, 2, 4)
    dth = pad(dt, (0, 0, qp - q, 0)).permute(0, 1, 3, 2)             # b c h q
    cumh = pad(cum, (0, 0, qp - q, 0)).permute(0, 1, 3, 2)
    Bp, Cp = pad(B, (0, 0, qp - q, np_ - n)), pad(C, (0, 0, qp - q, np_ - n))
    gstp = pad(gst, (0, 0, 0, np_ - n, pp - p))                      # b c h n p
    pos = torch.arange(qp)
    valid = pos < q
    last = cum[:, :, -1, :][..., None]                               # b c h 1
    ex = torch.exp(last - cumh)
    T = slice

    def rows(i):
        return T(i * TILE, (i + 1) * TILE)

    def decay(lt, st):
        """exp of the masked cum_l - cum_s: (b, c, h, l, s)."""
        li, si = pos[rows(lt)], pos[rows(st)]
        ok = (li[:, None] >= si[None, :]) & valid[rows(lt)][:, None] \
            & valid[rows(st)][None, :]
        seg = cumh[..., rows(lt), None] - cumh[..., None, rows(st)]
        return torch.exp(torch.where(ok, seg, torch.tensor(-1e30)))

    pairs = [(lt, st) for lt in range(tiles) for st in range(lt + 1)]

    # ssd_bwd_cb: C_l B_s^T once a causal pair, over n in k8 steps
    cb = torch.zeros(bb, nc, qp, qp)
    for lt, st in pairs:
        cb[:, :, rows(lt), rows(st)] = _mma(
            None, Cp[:, :, rows(lt)], Bp[:, :, rows(st)].transpose(-1, -2),
            passes)

    # ssd_bwd_ds: per pair and head group, dS = gy_l x_s^T a head; row sums
    # of P over the s tile, column sums of Q over the l tile (each warp's
    # 16 rows, then the four warps in order); gCB summed over the group's
    # heads in order, then over the groups in order as bc stages it
    gcbp = torch.zeros(bb, nc, groups, qp, qp)
    rowp = torch.zeros(bb, nc, h, tiles, qp)
    colq = torch.zeros(bb, nc, h, tiles, qp)
    for lt, st in pairs:
        ds = _mma(None, gyh[..., rows(lt), :],
                  xh[..., rows(st), :].transpose(-1, -2), passes)
        e = decay(lt, st)
        d = dth[..., None, rows(st)]
        qq = ds * cb[:, :, None, rows(lt), rows(st)] * e
        rowp[..., st, rows(lt)] = (qq * d).sum(-1)
        warps = [qq[..., 16 * w:16 * w + 16, :].sum(-2) for w in range(4)]
        colq[..., lt, rows(st)] = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        term = ds * e * d
        for grp in range(groups):
            tile = torch.zeros(bb, nc, TILE, TILE)
            for hd in range(grp * hg, min(h, (grp + 1) * hg)):
                tile = tile + term[:, :, hd]
            gcbp[:, :, grp, rows(lt), rows(st)] = tile
    gcb = gcbp[:, :, 0]
    for grp in range(1, groups):
        gcb = gcb + gcbp[:, :, grp]

    # ssd_bwd_dx: U = B_s gst_h over n, r over p, U scaled by
    # exp(cum_last - cum_s), then (C.B^T * E)^T gy_l over the causal l
    # tiles from cb's scratch, times dt_s
    gx = torch.zeros(bb, nc, h, qp, pp)
    rbuf = torch.zeros(bb, nc, h, qp)
    for st in range(tiles):
        acc = _mma(None, Bp[:, :, None, rows(st)], gstp, passes)
        rbuf[..., rows(st)] = (xh[..., rows(st), :] * acc).sum(-1)
        acc = acc * ex[..., rows(st), None]
        for lt in range(st, tiles):
            a = cb[:, :, None, rows(lt), rows(st)].transpose(-1, -2) \
                * decay(lt, st).transpose(-1, -2)
            acc = _mma(acc, a, gyh[..., rows(lt), :], passes)
        gx[..., rows(st), :] = acc * dth[..., rows(st), None]

    # ssd_bwd_bc: gC = gCB B over the causal s tiles; gB = gCB^T C over the
    # causal l tiles, then (w_h x_h) gst_h^T over the heads in order
    gC, gB = torch.zeros(bb, nc, qp, np_), torch.zeros(bb, nc, qp, np_)
    w = ex * dth
    for rt in range(tiles):
        acc = None
        for st in range(rt + 1):
            acc = _mma(acc, gcb[:, :, rows(rt), rows(st)], Bp[:, :, rows(st)],
                       passes)
        gC[:, :, rows(rt)] = acc
        acc = None
        for lt in range(rt, tiles):
            acc = _mma(acc, gcb[:, :, rows(lt), rows(rt)].transpose(-1, -2),
                       Cp[:, :, rows(lt)], passes)
        for hd in range(h):
            wx = xh[:, :, hd, rows(rt)] * w[:, :, hd, rows(rt), None]
            acc = _mma(acc, wx, gstp[:, :, hd].transpose(-1, -2), passes)
        gB[:, :, rows(rt)] = acc

    # ssd_bwd_reduce: the partials in tile order, the state terms, and the
    # last row's sum of w r
    gcum = torch.zeros(bb, nc, h, qp)
    gdt = torch.zeros(bb, nc, h, qp)
    for lt in range(tiles):
        rs = torch.zeros(bb, nc, h, TILE)
        for i in range(lt + 1):
            rs = rs + rowp[..., i, rows(lt)]
        cs = torch.zeros(bb, nc, h, TILE)
        for i in range(lt, tiles):
            cs = cs + colq[..., i, rows(lt)]
        d, e, r = dth[..., rows(lt)], ex[..., rows(lt)], rbuf[..., rows(lt)]
        gdt[..., rows(lt)] = cs + e * r
        gcum[..., rows(lt)] = rs - d * cs - e * d * r
    gcum[..., q - 1] += (w * rbuf)[..., :q].sum(-1)

    def unpad_h(t, last_dim=None):
        t = t[..., :q, :last_dim] if last_dim else t[..., :q]
        return t.transpose(2, 3) if last_dim is None else \
            t.permute(0, 1, 3, 2, 4)

    return (unpad_h(gx, p), gdt[..., :q].transpose(2, 3),
            gcum[..., :q].transpose(2, 3), gB[:, :, :q, :n], gC[:, :, :q, :n])


@pytest.mark.parametrize("bb,l,chunk,h,p,n", [
    (2, 512, 256, 3, 64, 128),   # mamba2-130m's chunk, p and n
    (1, 300, 256, 4, 64, 128),   # one ragged chunk of 300
    (2, 128, 32, 3, 16, 24),     # small p and n: zero-filled tiles
])
def test_kernel_tiling_fits_the_tolerance(bb, l, chunk, h, p, n):
    """The spec ssd_bwd.cu keeps in step with: its 3xTF32 products and
    partial sums hold every gradient within 1e-4 of max|g| of the plain
    backward in float64, at mamba2-130m's widths where one TF32 product
    a k8 step does not."""
    ops_np = _chunk_operands(bb, l, chunk, h, p, n, seed=l)
    ops32 = [torch.from_numpy(a) for a in ops_np]
    want = t_ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in ops32))
    got = _emulate_bwd_kernels(*ops32)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        assert _rel(a, w) <= KERNEL_TOL, (name, _rel(a, w))
    if p == 64:
        one = _emulate_bwd_kernels(*ops32, passes=1)
        assert max(_rel(a, w) for a, w in zip(one, want)) > KERNEL_TOL


# ssd_bwd_launch's grids as the C side builds and decodes them (the spec
# to keep in step with ssd_bwd.cu's launch and its kernels' block index)
DX_HEADS = 4   # heads of a ssd_bwd_dx block, one after another (HX)


def _grids(plan: dict, cells: int, h: int) -> dict:
    """Each grid's (x, y, z) blocks."""
    tiles, halves = plan["tiles"], plan["halves"]
    pairs = tiles * (tiles + 1) // 2
    return {"ssd_bwd_cb": (pairs, cells, 1),
            "ssd_bwd_ds": (pairs, plan["groups"], cells),
            "ssd_bwd_dx": (tiles, -(-h // DX_HEADS), cells),
            "ssd_bwd_bc": (tiles * halves, 2, cells),
            "ssd_bwd_reduce": (h, cells, 1)}


def _pair_of(x: int) -> tuple[int, int]:
    """The causal (l tile, s tile) pair of block x of the cb and ds grids:
    l tiles in order, s <= l."""
    lt = 0
    while (lt + 1) * (lt + 2) // 2 <= x:
        lt += 1
    return lt, x - lt * (lt + 1) // 2


def _block_work(plan: dict, cells: int, h: int):
    """What each block computes: yields (grid, block, items) with items
    the (cell, head, l tile, s tile) products of ds and dx, the (cell, l
    tile, s tile) C.B^T tiles of cb, and the (cell, gC or gB, row tile, n
    half) outputs of bc with the causal tiles and heads they walk."""
    tiles, halves, hg = plan["tiles"], plan["halves"], t_kernel.BWD_HEAD_GROUP
    pairs = tiles * (tiles + 1) // 2
    for cell in range(cells):
        for x in range(pairs):
            yield "ssd_bwd_cb", (x, cell, 0), [(cell,) + _pair_of(x)]
    for cell in range(cells):
        for grp in range(plan["groups"]):
            for x in range(pairs):
                lt, st = _pair_of(x)
                heads = range(grp * hg, min(h, (grp + 1) * hg))
                yield "ssd_bwd_ds", (x, grp, cell), \
                    [(cell, hd, lt, st) for hd in heads]
    for cell in range(cells):
        for grp in range(-(-h // DX_HEADS)):
            for st in range(tiles):
                heads = range(grp * DX_HEADS, min(h, (grp + 1) * DX_HEADS))
                yield "ssd_bwd_dx", (st, grp, cell), \
                    [(cell, hd, lt, st) for hd in heads
                     for lt in range(st, tiles)]
    for cell in range(cells):
        for which in range(2):
            for x in range(tiles * halves):
                rt, nh = divmod(x, halves)
                walk = ([("s", st) for st in range(rt + 1)] if which == 0 else
                        [("l", lt) for lt in range(rt, tiles)]
                        + [("head", hd) for hd in range(h)])
                yield "ssd_bwd_bc", (x, which, cell), \
                    [(cell, "gB" if which else "gC", rt, nh, walk)]


@pytest.mark.parametrize("cells,q,h,p,n", [
    (2, 300, 3, 64, 128),    # one ragged chunk of 300 at 3 heads (g = 8)
    (3, 256, 24, 64, 128),   # mamba2-130m's chunk, heads, p and n
    (1, 40, 12, 16, 24),     # 12 heads (g = 2): a head group h does not fill
    (2, 96, 13, 10, 20),     # p and n off TMA's 16-byte strides
])
def test_bwd_launch_plan_covers_every_product_once(cells, q, h, p, n):
    """The backward's grids, decoded block by block as ssd_bwd.cu decodes
    them over the wrapper's plan: cb builds each causal C.B^T tile of each
    cell once; ds and dx each take every (cell, head, l tile, s tile)
    product of a causal pair once (by head groups of ``BWD_HEAD_GROUP``
    and ``DX_HEADS``); bc writes each (cell, gC or gB, row tile, n half)
    once, walking its causal tiles, and for gB every head, in order; the
    scratch holds every tile."""
    plan = t_kernel.bwd_plan(cells, q, h, p, n)
    grids = _grids(plan, cells, h)
    tiles, hg = plan["tiles"], t_kernel.BWD_HEAD_GROUP
    assert plan["qp"] == TILE * tiles and tiles * TILE - TILE < q <= tiles * TILE
    assert (plan["groups"] - 1) * hg < h <= plan["groups"] * hg
    assert plan["halves"] * TILE >= n > (plan["halves"] - 1) * TILE
    pairs = [(lt, st) for lt in range(tiles) for st in range(lt + 1)]
    seen = {name: [] for name in grids}
    blocks = {name: set() for name in grids}
    for grid, block, items in _block_work(plan, cells, h):
        assert all(0 <= b < d for b, d in zip(block, grids[grid]))
        assert block not in blocks[grid]
        blocks[grid].add(block)
        seen[grid] += items
    for grid in ("ssd_bwd_cb", "ssd_bwd_ds", "ssd_bwd_dx", "ssd_bwd_bc"):
        x, y, z = grids[grid]
        assert len(blocks[grid]) == x * y * z, grid
    assert sorted(seen["ssd_bwd_cb"]) == sorted(
        (c, lt, st) for c in range(cells) for lt, st in pairs)
    products = sorted((c, hd, lt, st) for c in range(cells) for hd in range(h)
                      for lt, st in pairs)
    assert sorted(seen["ssd_bwd_ds"]) == products
    assert sorted(seen["ssd_bwd_dx"]) == products
    outputs = {(c, which, rt, nh): walk
               for c, which, rt, nh, walk in seen["ssd_bwd_bc"]}
    assert len(outputs) == len(seen["ssd_bwd_bc"]) == \
        cells * 2 * tiles * plan["halves"]
    for (c, which, rt, nh), walk in outputs.items():
        want = ([("s", st) for st in range(rt + 1)] if which == "gC" else
                [("l", lt) for lt in range(rt, tiles)]
                + [("head", hd) for hd in range(h)])
        assert walk == want
    assert plan["scratch"]["gcbp"] == (cells, plan["groups"], plan["qp"],
                                       plan["qp"])
    assert plan["scratch"]["rowp"] == plan["scratch"]["colq"] == \
        (cells, tiles, h, q)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bb,l,chunk,h,p,n", SHAPES + [
    (4, 512, 256, 24, 64, 128),   # mamba2-130m full width
    (4, 300, 256, 24, 64, 128),   # one chunk of 300
    (1, 300, 256, 3, 64, 128),    # 3 heads and q 300: a ragged head group
                                  # and a ragged tile together
    (1, 96, 32, 3, 10, 20),       # p and n off TMA's 16-byte row strides
])
def test_kernels_match_plain_backward_on_card(bb, l, chunk, h, p, n):
    dev = _card()
    ops32 = [torch.from_numpy(a).to(dev)
             for a in _chunk_operands(bb, l, chunk, h, p, n, seed=l)]
    before = t_kernel.bwd_launches
    got = t_kernel.ssd_intra_chunk_bwd_kernel(*ops32)
    want = t_ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in ops32))
    torch.cuda.synchronize()
    assert t_kernel.bwd_launches == before + 1
    for name, a, w in zip(NAMES, got, want):
        assert _rel(a.cpu(), w.cpu()) <= KERNEL_TOL, name


@pytest.mark.gpu
def test_built_backward_matches_its_plan_on_card():
    """The built library's head groups are the spec's (ds's sizes gCB's
    scratch), and each of the four tiled grids fits two blocks (one
    warpgroup each) on an SM: at most 113 KB of shared memory a block."""
    _card()
    assert t_kernel.built_head_groups() == (t_kernel.BWD_HEAD_GROUP,
                                            DX_HEADS)
    smem = t_kernel.bwd_smem_bytes()
    assert tuple(smem) == ("ssd_bwd_cb", "ssd_bwd_ds", "ssd_bwd_dx",
                           "ssd_bwd_bc")
    assert all(0 < v <= 113 * 1024 for v in smem.values()), smem
    assert all(n == 2 for n in t_kernel.bwd_blocks_per_sm().values())


@pytest.mark.gpu
def test_kernel_backward_is_deterministic_on_card():
    """No atomics: two launches on the same inputs are bit-equal, at
    mamba2-130m's training shape (4 x 2048 tokens)."""
    dev = _card()
    ops32 = [torch.from_numpy(a).to(dev)
             for a in _chunk_operands(4, 2048, 256, 24, 64, 128, seed=9)]
    first, second = (t_kernel.ssd_intra_chunk_bwd_kernel(*ops32)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2, 8])
def test_op_gradients_go_through_the_kernels_on_card(g):
    """One backward launch a group; the gradients of x, dt, A, B and C
    within 1e-4 of max|g| of the plain op's."""
    dev = _card()
    args = [torch.from_numpy(a).to(dev)
            for a in _inputs(2, 512, 24, 64, 128, seed=g, g=g)]
    if g == 1:
        args[3], args[4] = args[3][:, :, 0], args[4][:, :, 0]

    def grads(op):
        leaves = [t.clone().requires_grad_() for t in args]
        y, states, _ = op(*leaves, chunk=256)
        return torch.autograd.grad(y.square().sum() + states.sum(), leaves)

    before = t_kernel.bwd_launches
    got = grads(t_ops.ssd_intra_chunk)
    assert t_kernel.bwd_launches == before + g
    want = grads(t_ops.ssd_intra_chunk_plain)
    for a, w in zip(got, want):
        assert _rel(a.cpu(), w.cpu()) <= KERNEL_TOL


@pytest.mark.gpu
def test_mamba2_train_step_runs_through_the_kernels_on_card(monkeypatch):
    """bf16 smoke step: the backward kernel once a layer, the forward
    twice (layer remat), and the loss and every gradient leaf within
    chip_smoke.py's bf16 tolerances of the same step through the plain
    SSD and its plain backward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import init_params
    from repro_torch.train.step import grads_of
    from repro_torch.types import param_values, tree_leaves

    dev = _card()
    cfg = get_smoke_config("mamba2-130m")
    params = param_values(init_params(0, cfg, device=dev))
    batch = make_batch(cfg, 4, 128, seed=1, device=dev)
    fwd, bwd = t_kernel.launches, t_kernel.bwd_launches
    g_k, m_k = grads_of(params, batch, cfg)
    assert t_kernel.bwd_launches == bwd + cfg.num_layers
    assert t_kernel.launches == fwd + 2 * cfg.num_layers
    monkeypatch.setattr(t_ops, "ssd_intra_chunk", t_ops.ssd_intra_chunk_plain)
    g_p, m_p = grads_of(params, batch, cfg)
    assert float(m_k["loss"]) == pytest.approx(float(m_p["loss"]), rel=1e-2)
    for a, c in zip(tree_leaves(g_k), tree_leaves(g_p)):
        rel = float((a.float() - c.float()).norm()
                    / c.float().norm().clamp_min(1e-30))
        assert rel <= 5e-2, rel

"""The LLC replay kernels (``csrc/llc.cu``) and their plain versions.

``_emulate_set_walk`` and ``_emulate_lane_scan`` are numpy copies of
the kernels' walks and are the spec to keep in step with
``csrc/llc.cu``: the set walk a warp of 32 sets walking staged chunks
of 32 arrivals, the victim by the first-index argmax tree; the lane
scan every thread of the block table (``kernel.launch_plan``: one
launch for every lane bucket) running the kernel's 32-bit arithmetic,
divisions by a reciprocal (``_fastdiv``), the round's tag t0 + k, the
argmin tree, the suffix's ranks taken mod ways without a division.
Int32 sums wrap as uint32.  On the CPU they are held bit for bit to the
plain versions (``kernels/llc/ref.py``, the loops ``core/cache.py`` ran)
over hypothesis-drawn arrivals, traces, geometries and bucket sets and
at explicit edges (ties, wraps, int32 limits, odd strides and way
counts, masks, every suffix mode), and stand in for the kernels to show
that a CUDA tensor takes the kernel route through ``core.cache`` and
never the plain loop, Fig. 5's frame in one launch.  The ``gpu`` cases
hold the built kernels to the plain versions on the card, bit for
bit.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import cache  # noqa: E402
from repro_torch.core.cache import LLCConfig  # noqa: E402
from repro_torch.kernels.llc import kernel as K  # noqa: E402
from repro_torch.kernels.llc import ops, ref  # noqa: E402

IMAX = 2**31 - 1
M32 = 2**32 - 1
WALK_THREADS = WALK_CHUNK = 32   # llc.cu: a warp a block, a set's chunk


def _i32(x):
    """Ints (or int64 arrays) wrapped to int32, as a uint32 sum cast back."""
    return ((x + 2**31) & M32) - 2**31


def _template_ways(ways: int) -> int:
    """The kernels' compile-time way bound for ``ways`` (their dispatch)."""
    return next((w for w in (2, 4, 8, 16, 32, 64) if ways <= w), 128)


# --------------------------------------------------------------------------
# the spec: llc.cu's walks in numpy
# --------------------------------------------------------------------------
def _fastdiv(d: int) -> tuple[int, int]:
    """``make_fastdiv``: (mul, shift) with floor(n / d) = (mulhi(n, mul)
    + n) >> shift for every n < 2**32."""
    shift = (d - 1).bit_length()          # 32 - __clz(d - 1)
    return (((1 << shift) - d) << 32) // d + 1, shift


def _magic(d):
    """``make_fastdiv`` of every element of ``d``: (mul, shift) arrays."""
    uniq, inv = np.unique(np.asarray(d, np.int64), return_inverse=True)
    ms = np.asarray([_fastdiv(int(v)) for v in uniq], np.uint64)
    return ms[inv.reshape(np.shape(d)), 0], ms[inv.reshape(np.shape(d)), 1]


def _div(n, magic):
    """``FastDiv::div``, elementwise: n < 2**32 (int64 array) over the
    divisors of ``magic``, broadcast."""
    mul, shift = magic
    n = np.asarray(n, np.int64).astype(np.uint64)
    return ((((n * mul) >> np.uint64(32)) + n) >> shift).astype(np.int64)


def _first(v, better):
    """``argmax_first`` / ``argmin_first`` over the last axis (W <= 32):
    adjacent ranges combine, the right side taken on a strict compare.
    Wider sets scan in order (the first index of the extreme, the
    same).  Returns (index, value)."""
    v = v.copy()
    width = v.shape[-1]
    idx = np.broadcast_to(np.arange(width), v.shape).copy()
    if width > 32:
        pick = np.argmax(v, -1) if better is np.greater else np.argmin(v, -1)
        return pick, np.take_along_axis(v, pick[..., None], -1)[..., 0]
    w = 1
    while w < width:
        for q in range(0, width - w, 2 * w):
            take = better(v[..., q + w], v[..., q])
            v[..., q] = np.where(take, v[..., q + w], v[..., q])
            idx[..., q] = np.where(take, idx[..., q + w], idx[..., q])
        w *= 2
    return idx[..., 0], v[..., 0]


def _emulate_set_walk(tags, age, tag_s, acc_s, per_set, first, hit_s):
    """``llc_set_walk_kernel``: a block of 32 lanes walks 32 sets; each
    chunk of 32 arrivals a set is staged, walked (scores: INT32_MAX for a
    matching tag, the age otherwise, IMIN past the real ways; the argmax
    tree), and its hit bits written out; tags / age (sets, ways) int32
    walked in place, hit_s (n,) bool written."""
    sets, ways = tags.shape
    width = _template_ways(ways)
    q = np.arange(width)
    for b0 in range(0, sets, WALK_THREADS):
        lanes = range(b0, min(b0 + WALK_THREADS, sets))
        n = [int(per_set[s]) for s in lanes]
        f = [int(first[s]) for s in lanes]
        tg = np.zeros((len(n), width), np.int64)
        ag = np.zeros((len(n), width), np.int64)
        tg[:, :ways], ag[:, :ways] = tags[b0:b0 + len(n)], age[b0:b0 + len(n)]
        for c in range(-(-max(n) // WALK_CHUNK)):
            # the ring slot: lane i's arrivals c * 32 .. c * 32 + 31
            runs = [slice(fi + c * WALK_CHUNK,
                          fi + min(ni, (c + 1) * WALK_CHUNK))
                    for fi, ni in zip(f, n)]
            slot = [(tag_s[r], acc_s[r]) for r in runs]
            hit_sm = [[] for _ in n]
            for lane, (ts_, as_) in enumerate(slot):
                for t, a in zip(ts_.tolist(), as_.tolist()):
                    match = (q < ways) & (tg[lane] == t)
                    score = np.where(q < ways, np.where(match, IMAX, ag[lane]),
                                     -2**31)
                    way, _ = _first(score, np.greater)
                    aged = _i32(ag[lane] + (a & M32))
                    ag[lane] = np.where(q == way, 0, aged)
                    tg[lane] = np.where(q == way, t, tg[lane])
                    hit_sm[lane].append(bool(match.any()))
            for lane, hits in enumerate(hit_sm):
                at = f[lane] + c * WALK_CHUNK
                hit_s[at:at + len(hits)] = hits
        tags[b0:b0 + len(n)] = tg[:, :ways]
        age[b0:b0 + len(n)] = ag[:, :ways]


def _wsel_bits(wsel, q):
    """Bit q of each int64 mask: its sign bit past bit 63."""
    low = (wsel[:, None] >> np.minimum(q, 63)[None, :]) & 1
    return np.where(q[None, :] < 64, low, wsel[:, None] < 0).astype(bool)


def _emulate_lane_scan(buckets, blocks, outs, threads=K.SCAN_THREADS):
    """``llc_lane_scan_kernel`` over the block table ``blocks`` ((n, 3):
    bucket, lane, first set), vectorized over the launch's threads, each
    running the kernel's 32-bit arithmetic on its own (bucket, lane,
    set).  ``buckets``: per bucket (table, rounds, geo, sizes) numpy;
    ``outs``: per bucket (hits, miss or None, tags, ts) numpy, written
    as the kernel writes them (hits and miss bits on zeros)."""
    width = _template_ways(max(b[3]["max_ways"] for b in buckets))
    q = np.arange(width)
    bk = np.repeat(blocks[:, 0], threads).astype(np.int64)
    ln = np.repeat(blocks[:, 1], threads).astype(np.int64)
    s = (blocks[:, 2, None].astype(np.int64) + np.arange(threads)).ravel()
    n_thr = s.shape[0]

    def per_bucket(name):
        return np.asarray([b[3][name] for b in buckets], np.int64)[bk]

    n_seg, max_sets, max_ways, suffix = (per_bucket(k) for k in (
        "n_seg", "max_sets", "max_ways", "suffix"))
    geo = np.zeros((n_thr, 3), np.int64)
    for b, (_, _, g, _) in enumerate(buckets):
        geo[bk == b] = g[ln[bk == b]]
    sets, ways, bb = geo.T
    by_sets, by_ways = _magic(sets), _magic(ways)
    in_state = s < max_sets
    active = in_state & (s < sets)
    # padding ways (q >= ways) keep tag -1 and hold stamp INT32_MAX
    real = q[None, :] < ways[:, None]
    tg = np.full((n_thr, width), -1, np.int64)
    st = np.where(real, 0, IMAX)
    for j in range(int(n_seg.max())):
        f = np.zeros((n_thr, len(K.FIELDS)), np.int64)
        rounds = np.zeros(n_thr, np.int64)
        for b, (table, rnd, _, _) in enumerate(buckets):
            if j < table.shape[1]:
                m = bk == b
                f[m], rounds[m] = table[ln[m], j], rnd[j]
        base, stride, count, b_first, n_pre, sb_first, n_suf, counter, wsel = \
            f.T
        counter = counter & M32
        # derive: once a block in the kernel, the same in every thread
        qb = _div(b_first, by_sets)
        ub = b_first - qb * sets
        qsb = _div(sb_first, by_sets)
        usb = sb_first - qsb * sets
        by_stride = _magic(np.where(stride > 0, stride, 1))
        alloc = (q[None, :] < ways[:, None]) & (
            (wsel[:, None] == 0) | _wsel_bits(wsel, q))
        # the round walk
        wrap = s < ub
        i = np.where(wrap, s + sets - ub, s - ub)
        t = qb + wrap
        lo = ((b_first + i) * bb - base) & M32
        mine = np.zeros(n_thr, np.int64)
        for k in range(int(rounds.max(initial=0))):
            run = active & (k < rounds) & (i < n_pre)
            if not run.any():
                break
            j_hi = np.minimum(_div((lo + bb - 1) & M32, by_stride), count - 1)
            j_lo = np.where(_i32(lo) <= 0, 0,
                            _div((lo + stride - 1) & M32, by_stride))
            key = np.where(tg == t[:, None], -1, np.where(alloc, st, IMAX))
            way, kmin = _first(key, np.less)
            hit = kmin == -1
            upd = run[:, None] & (q[None, :] == way[:, None])
            tg = np.where(upd, t[:, None], tg)
            st = np.where(upd, _i32(counter + j_hi + 1)[:, None], st)
            mine += np.where(run, j_hi - j_lo + hit, 0)
            for b, (_, miss, _, _) in enumerate(outs):
                m = run & ~hit & (bk == b)
                if miss is not None and m.any():
                    miss[ln[m], j, k, s[m]] = True
            i, t, lo = i + sets, t + 1, (lo + sets * bb) & M32
        for b, (hits, _, _, _) in enumerate(outs):
            m = (bk == b) & (rounds > 0)
            if m.any():
                np.add.at(hits, (ln[m], j), mine[m])
        # the closed-form suffix
        wrap = s < usb
        off_suf = np.where(wrap, s + sets - usb, s - usb)
        t_suf = qsb + wrap
        blk0 = (sb_first + off_suf) & M32
        ins = active & (j < n_seg) & (suffix != 0) & (n_suf > 0) \
            & (off_suf < n_suf)
        vt = st.copy()   # the victim order before the insert

        def stamp(blk):
            x = (blk * bb - base + bb - 1) & M32
            last = np.minimum(_div(x, by_stride), count - 1)
            return _i32(counter + last + 1)

        one = ins & (suffix == 1)
        if one.any():
            way, _ = _first(vt, np.less)
            upd = one[:, None] & (q[None, :] == way[:, None])
            tg = np.where(upd, t_suf[:, None], tg)
            st = np.where(upd, stamp(blk0)[:, None], st)
        full = ins & (suffix == 2)
        if full.any():
            m_ = _div((n_suf - off_suf + sets - 1) & M32, by_sets)
            e = (m_ - 1) & M32
            e = e - _div(e, by_ways) * ways
            # padding (INT32_MAX, to the right) precedes no real way, so the
            # kernel's compares over its real ways or its pairs agree
            older = (vt[:, None, :] < vt[:, :, None]) | (
                (vt[:, None, :] == vt[:, :, None]) & (q[None, :] < q[:, None]))
            rank = older.sum(-1)
            dd = np.where(e[:, None] >= rank, e[:, None] - rank,
                          e[:, None] + ways[:, None] - rank)
            valid = full[:, None] & real & (dd < m_[:, None])
            back = m_[:, None] - 1 - dd
            blk = (blk0[:, None] + back * sets[:, None]) & M32
            x = (blk * bb[:, None] - base[:, None] + bb[:, None] - 1) & M32
            last = np.minimum(
                _div(x, (by_stride[0][:, None], by_stride[1][:, None])),
                count[:, None] - 1)
            tg = np.where(valid, t_suf[:, None] + back, tg)
            st = np.where(valid, _i32(counter[:, None] + last + 1), st)
    for b, (_, _, tags, ts) in enumerate(outs):
        m = (bk == b) & in_state
        mw = buckets[b][3]["max_ways"]
        at = (ln[m][:, None], np.arange(mw)[None, :], s[m][:, None])
        tags[at], ts[at] = tg[m, :mw], np.where(real[m, :mw], st[m, :mw], 0)


def _launch_outs(sizes, collect=True, fill=7):
    """A bucket's outputs as the kernel finds them: hits and miss bits
    zero, the state garbage (the kernel writes all of it)."""
    lanes, n_seg = sizes["lanes"], sizes["n_seg"]
    state = (lanes, sizes["max_ways"], sizes["max_sets"])
    return (np.zeros((lanes, n_seg), np.int64),
            np.zeros((lanes, n_seg, sizes["r_pad"], sizes["max_sets"]), bool)
            if collect else None,
            np.full(state, fill, np.int32), np.full(state, fill, np.int32))


def _set_walk_stand_in(calls):
    def launch(tags, age, tag_s, acc_s, per_set, first, hit_s):
        calls.append("set_walk")
        _emulate_set_walk(tags.numpy(), age.numpy(), tag_s.numpy(),
                          acc_s.numpy(), per_set.numpy(), first.numpy(),
                          hit_s.numpy())
    return launch


def _lane_scan_stand_in(calls):
    def launch(plans, outs, depths):
        calls.append("lane_scan")
        blocks = K.launch_plan([p[3] for p in plans], depths)
        _emulate_lane_scan(
            [(p[0].numpy(), p[1].numpy(), p[2].numpy(), p[3]) for p in plans],
            blocks, [tuple(None if o is None else o.numpy() for o in out)
                     for out in outs])
    return launch


def _no_plain(*a, **k):
    raise AssertionError("a CUDA tensor took the plain loop")


# --------------------------------------------------------------------------
# drawn inputs
# --------------------------------------------------------------------------
@st.composite
def _arrivals(draw):
    """Set-sorted arrivals of one geometry and a warm (or cold) state:
    ways 1-8, not powers of two (12, 20) and past the kernels' register
    bound (40, 128), tags
    from a small range so that sets hit, ages and access counts over all
    of int32 so that sums wrap."""
    sets = draw(st.sampled_from([1, 2, 4, 8]))
    ways = draw(st.one_of(st.integers(1, 8),
                          st.sampled_from([12, 16, 20, 40, 128])))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    per_set = rng.integers(0, 12, sets)
    n = int(per_set.sum())
    first = np.cumsum(per_set) - per_set
    tags = rng.integers(-1, 6, (sets, ways)).astype(np.int32)
    if draw(st.booleans()):
        age = rng.integers(-2**31, 2**31, (sets, ways)).astype(np.int32)
    else:
        age = np.zeros((sets, ways), np.int32)
        tags[:] = -1
    tag_s = rng.integers(0, 6, n).astype(np.int32)
    big = draw(st.booleans())
    acc_s = rng.integers(1, 2**31 if big else 40, n).astype(np.int32)
    return tags, age, tag_s, acc_s, per_set, first


@st.composite
def _lane_plans(draw):
    """A lane batch's host plan through ``cache._lane_plan_tables``:
    ways 1-8, 12, 16, 20 and 40 (one set included), blocks of 32/64/128
    bytes, strides that do and do not divide them, a shared or
    per-lane stream with padding segments, cold flags, masks including
    0 and the full mask, and every suffix mode."""
    n_lane = draw(st.integers(1, 3))
    geos = [(draw(st.sampled_from([1, 2, 4, 8])),
             draw(st.one_of(st.integers(1, 8),
                            st.sampled_from([12, 16, 20, 40]))),
             draw(st.sampled_from([32, 64, 128]))) for _ in range(n_lane)]
    sets, ways, bbs = (np.asarray(v, np.int64) for v in zip(*geos))
    n_seg = draw(st.integers(1, 8))
    rows = n_lane if draw(st.booleans()) else 1
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    stride_max = int(bbs.min())
    bases = rng.integers(0, 64, (rows, n_seg)) * 16
    strides = rng.choice(
        [s for s in (4, 8, 12, 16, 24, 32) if s <= stride_max], (rows, n_seg))
    counts = rng.integers(0, 48, (rows, n_seg))
    counts[rng.random((rows, n_seg)) < 0.15] = 0
    cold = rng.random((rows, n_seg)) < 0.3
    way_sels = None
    if draw(st.booleans()):
        full = (1 << ways[:, None]) - 1
        pick = rng.integers(0, 4, (n_lane, n_seg))
        way_sels = np.where(pick == 0, 0, np.where(
            pick == 1, full, rng.integers(1, 256, (n_lane, n_seg)) & full))
        way_sels = np.where((pick > 1) & (way_sels == 0), full, way_sels)
    shape = (n_lane, n_seg)
    b, s_, c = (np.broadcast_to(a, shape) for a in (bases, strides, counts))
    nb = np.where(c > 0, (b + (c - 1) * s_) // bbs[:, None]
                  - b // bbs[:, None] + 1, 0)
    r_needed = np.minimum(ways[:, None], -(-nb // sets[:, None]))
    if way_sels is not None:
        r_needed = np.where(way_sels != 0, -(-nb // sets[:, None]),
                            r_needed)
    r_pad = max(1, int(r_needed.max())) + draw(st.integers(0, 1))
    suffix = draw(st.sampled_from(["full", "one", "none"]))
    table, rounds, geo, _ = cache._lane_plan_tables(
        bases, strides, counts, r_needed, cold, sets, ways, bbs, way_sels,
        r_pad=r_pad, suffix=suffix)
    return (table, rounds, geo, int(sets.max()), int(ways.max()), r_pad,
            suffix)


def _plain_lane_scan(table, rounds, geo, max_sets, max_ways, r_pad, suffix,
                     collect=True):
    return ref.lane_scan_ref(torch.as_tensor(table), torch.as_tensor(rounds),
                             torch.as_tensor(geo), max_sets=max_sets,
                             max_ways=max_ways, r_pad=r_pad, collect=collect,
                             suffix=suffix)


def _sizes(table, rounds, geo, max_sets, max_ways, r_pad, suffix):
    return K.bucket_sizes(torch.as_tensor(table), torch.as_tensor(rounds),
                          torch.as_tensor(geo), max_sets=max_sets,
                          max_ways=max_ways, r_pad=r_pad, suffix=suffix)


def _emulated_lane_scan_many(plans, collect=True):
    """Lane batches (each ``_lane_plans``' tuple) through one emulated
    launch: the block table, then the kernel's threads."""
    sizes = [_sizes(*p) for p in plans]
    outs = [_launch_outs(sz, collect) for sz in sizes]
    blocks = K.launch_plan(sizes, [int(np.sum(p[1])) for p in plans])
    _emulate_lane_scan([(p[0], p[1], p[2], sz) for p, sz in zip(plans, sizes)],
                       blocks, outs)
    return outs


def _emulated_lane_scan(table, rounds, geo, max_sets, max_ways, r_pad,
                        suffix):
    return _emulated_lane_scan_many([(table, rounds, geo, max_sets, max_ways,
                                      r_pad, suffix)])[0]


def _assert_lane_scan_equal(got, want, collect=True):
    np.testing.assert_array_equal(got[0], want[0].numpy())
    if collect:
        np.testing.assert_array_equal(got[1], want[1].numpy())
    else:
        assert want[1] is None
    np.testing.assert_array_equal(got[2], want[2].numpy())
    np.testing.assert_array_equal(got[3], want[3].numpy())


# --------------------------------------------------------------------------
# the spec against the plain versions (CPU)
# --------------------------------------------------------------------------
@settings(max_examples=150, deadline=None, database=None)
@given(case=_arrivals())
def test_set_walk_emulation_is_the_plain_walk(case):
    tags, age, tag_s, acc_s, per_set, first = case
    hit, want_tags, want_age = ref.set_walk_ref(
        *(torch.as_tensor(a) for a in case))
    tg, ag = tags.copy(), age.copy()
    got = np.zeros(tag_s.shape, bool)
    _emulate_set_walk(tg, ag, tag_s, acc_s, per_set, first, got)
    np.testing.assert_array_equal(got, hit.numpy())
    np.testing.assert_array_equal(tg, want_tags.numpy())
    np.testing.assert_array_equal(ag, want_age.numpy())


@settings(max_examples=150, deadline=None, database=None)
@given(plan=_lane_plans(), collect=st.booleans())
def test_lane_scan_emulation_is_the_plain_scan(plan, collect):
    want = _plain_lane_scan(*plan, collect=collect)
    got = _emulated_lane_scan(*plan)
    _assert_lane_scan_equal(got, want, collect)


@settings(max_examples=60, deadline=None, database=None)
@given(plans=st.lists(_lane_plans(), min_size=1, max_size=3),
       collect=st.booleans())
def test_one_launch_of_many_buckets_is_each_buckets_plain_scan(plans,
                                                               collect):
    """Lane batches of different sets, ways, round counts and suffix
    modes through one emulated launch (the block table maps each block
    to its bucket) give each batch's own plain scan, bit for bit."""
    got = _emulated_lane_scan_many(plans, collect)
    for g, plan in zip(got, plans):
        _assert_lane_scan_equal(g, _plain_lane_scan(*plan, collect=collect),
                                collect)


# --------------------------------------------------------------------------
# the route: a CUDA tensor launches the kernel or raises
# --------------------------------------------------------------------------
def _trace(seed, n=40):
    rng = np.random.default_rng(seed)
    segs = []
    for _ in range(n):
        base = int(rng.integers(0, 96)) * 64
        stride = int(rng.choice([16, 32, 64, 96]))
        segs.append((base, stride, int(rng.integers(1, 40))))
    return segs


@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_route_launches_the_kernels_through_core_cache(monkeypatch,
                                                            seed):
    """With the ops seeing a CUDA device, ``core.cache``'s engines launch
    the kernels (stood in for by the emulation) and never the plain
    loops, and their results, warm state and masks included, are the
    plain route's bit for bit."""
    cfg = LLCConfig(2048, 4, 64)
    segs = _trace(seed)
    warm = cache.simulate_segments(_trace(seed + 10), cfg, device="cpu").state
    want = cache.simulate_segments(segs, cfg, warm, per_segment=True,
                                   collect_miss_runs=True, device="cpu")
    lane_segs = [s for s in segs if s[1] <= 32]
    b, s_, c = (np.asarray(v, np.int64) for v in zip(*lane_segs))
    sel = np.where(np.arange(b.shape[0]) % 3 == 0, 0x3, 0xC)
    lane_args = (b[None], s_[None], c[None], np.full(b.shape[0], 8),
                 np.zeros(b.shape[0], bool), [8], [4], [64], sel[None])
    lane_kw = dict(max_sets=8, max_ways=4, r_pad=8, collect=True,
                   suffix="none", return_state=True, device="cpu")
    want_lane = cache.segment_lane_scan(*lane_args, **lane_kw)

    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(ref, "lane_scan_ref", _no_plain)
    monkeypatch.setattr(K, "set_walk_kernel", _set_walk_stand_in(calls))
    monkeypatch.setattr(K, "lane_scan_kernel", _lane_scan_stand_in(calls))
    got = cache.simulate_segments(segs, cfg, warm, per_segment=True,
                                  collect_miss_runs=True, device="cpu")
    got_lane = cache.segment_lane_scan(*lane_args, **lane_kw)
    assert calls == ["set_walk", "lane_scan"]
    assert got.hits == want.hits and got.miss_runs == want.miss_runs
    np.testing.assert_array_equal(got.per_segment_hits,
                                  want.per_segment_hits)
    for a, w in zip(got.state, want.state):
        assert torch.equal(a, w)
    np.testing.assert_array_equal(got_lane[0], want_lane[0])
    np.testing.assert_array_equal(got_lane[1], want_lane[1])
    for a, w in zip(got_lane[2], want_lane[2]):
        np.testing.assert_array_equal(a, w)


def test_set_walk_does_not_write_its_inputs(monkeypatch):
    """The kernel walks copies: a warm state handed to the engine is
    left as it was."""
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(K, "set_walk_kernel", _set_walk_stand_in([]))
    tags = torch.full((2, 2), -1, dtype=torch.int32)
    age = torch.zeros((2, 2), dtype=torch.int32)
    _, new_tags, _ = ops.set_walk(
        tags, age, torch.tensor([3, 5], dtype=torch.int32),
        torch.ones(2, dtype=torch.int32), torch.tensor([1, 1]),
        torch.tensor([0, 1]))
    assert (tags == -1).all() and (age == 0).all()
    assert not torch.equal(new_tags, tags)


@pytest.mark.parametrize("engine", ["set_walk", "lane_scan"])
def test_cuda_route_raises_on_unsupported_ways(monkeypatch, engine):
    """More ways than the kernels' bound raise on CUDA: no plain loop
    and no launch."""
    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(ref, "lane_scan_ref", _no_plain)
    monkeypatch.setattr(K, "set_walk_kernel", _set_walk_stand_in(calls))
    monkeypatch.setattr(K, "lane_scan_kernel", _lane_scan_stand_in(calls))
    ways = K.MAX_WAYS + 1
    with pytest.raises(ValueError, match="ways"):
        if engine == "set_walk":
            cache.simulate_segments([(0, 64, 4)],
                                    LLCConfig(64 * ways, ways, 64),
                                    device="cpu")
        else:
            cache.segment_lane_scan([[0]], [[64]], [[4]], [1], [False], [1],
                                    [ways], [64], max_sets=1, max_ways=ways,
                                    r_pad=1, device="cpu")
    assert calls == []


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers take CUDA tensors only: nothing there falls
    back to the plain version."""
    z32 = torch.zeros((2, 2), dtype=torch.int32)
    z64 = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        K.set_walk_kernel(z32, z32.clone(), z32[0], z32[1], z64, z64,
                          torch.zeros(2, dtype=torch.bool))
    table = torch.zeros((1, 1, len(K.FIELDS)), dtype=torch.int64)
    rounds = torch.zeros(1, dtype=torch.int32)
    geo = torch.ones((1, 3), dtype=torch.int64)
    sizes = K.bucket_sizes(table, rounds, geo, max_sets=2, max_ways=2,
                           r_pad=1, suffix="full")
    with pytest.raises(ValueError, match="CUDA"):
        K.lane_scan_kernel([(table, rounds, geo, sizes)],
                           [(torch.zeros((1, 1), dtype=torch.int64), None,
                             z32[None], z32[None].clone())], [0])


# --------------------------------------------------------------------------
# explicit edges of the kernels' arithmetic (CPU)
# --------------------------------------------------------------------------
def test_fastdiv_is_exact_for_every_32_bit_dividend_class():
    """The reciprocal division the kernels take in place of every
    division by a stride, a set count or a way count: exact at the
    dividends' edges (0, d - 1, d, 2**31 - 1, 2**32 - 1, ...) and at
    random ones, for divisors 1-300, powers of two and their
    neighbours, and the largest."""
    rng = np.random.default_rng(5)
    divisors = list(range(1, 301)) + [2**k + e for k in range(9, 32)
                                      for e in (-1, 0, 1)] + [2**32 - 1]
    for d in divisors:
        n = np.concatenate([
            [0, 1, d - 1, d, d + 1, 2 * d - 1, 2**31 - 1, 2**31, 2**32 - 1,
             2**32 - d, (2**32 - 1) // d * d, (2**32 - 1) // d * d - 1],
            rng.integers(0, 2**32, 64)]).astype(np.int64)
        n = n[(n >= 0) & (n < 2**32)]
        mul, shift = _fastdiv(d)
        assert mul < 2**32
        np.testing.assert_array_equal(
            _div(n, (np.uint64(mul), np.uint64(shift))), n // d, err_msg=d)


def test_launch_plan_covers_every_lane_and_set_once():
    """The lane scan's block table: every (bucket, lane, set) of every
    bucket's state is one thread of one block, blocks start at multiples
    of the block's threads, and the buckets of the most rounds come
    first."""
    sizes = [dict(lanes=2, max_sets=16384), dict(lanes=4, max_sets=4096),
             dict(lanes=3, max_sets=1), dict(lanes=1, max_sets=100)]
    depths = [539, 1610, 2600, 0]
    blocks = K.launch_plan(sizes, depths)
    assert blocks.dtype == np.int32 and blocks.shape[1] == 3
    assert (blocks[:, 2] % K.SCAN_THREADS == 0).all()
    order = [b for i, b in enumerate(blocks[:, 0])
             if i == 0 or b != blocks[i - 1, 0]]
    assert order == [2, 1, 0, 3]
    for b, sz in enumerate(sizes):
        mine = blocks[blocks[:, 0] == b]
        cover = (mine[:, 2, None] + np.arange(K.SCAN_THREADS))
        for lane in range(sz["lanes"]):
            got = cover[mine[:, 1] == lane].ravel()
            got = np.sort(got[got < sz["max_sets"]])
            np.testing.assert_array_equal(got, np.arange(sz["max_sets"]))
        assert set(mine[:, 1]) == set(range(sz["lanes"]))


def _walk_case(name):
    """Explicit set-walk edges: ties among equal ages (a cold set of 128
    ways, a warm set of equal ages), ages that wrap int32, ways that are
    not powers of two, a tag in two ways, an age of INT32_MAX against a
    matching tag."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    sets, ways, warm = {"cold 128 ways": (2, 128, "cold"),
                        "equal ages": (4, 8, "equal"),
                        "ages wrap": (4, 8, "wrap"),
                        "12 ways": (4, 12, "warm"),
                        "20 ways": (2, 20, "warm"),
                        "duplicate tags": (2, 4, "dup")}[name]
    per_set = rng.integers(20, 70, sets)
    n = int(per_set.sum())
    first = np.cumsum(per_set) - per_set
    tags = np.full((sets, ways), -1, np.int32)
    age = np.zeros((sets, ways), np.int32)
    acc = rng.integers(1, 4, n)
    if warm == "equal":
        tags[:] = rng.permutation(ways)[None, :]
        age[:] = 1000
    elif warm == "wrap":
        tags[:] = rng.integers(0, 12, (sets, ways))
        age[:] = rng.integers(2**31 - 50, 2**31, (sets, ways))
        acc = rng.integers(2**30, 2**31, n)
    elif warm == "warm":
        tags[:] = rng.integers(0, 2 * ways, (sets, ways))
        age[:] = rng.integers(0, 40, (sets, ways))
    elif warm == "dup":
        tags[:] = [[3, 1, 3, 1]] * sets
        age[:] = [[2**31 - 1, 5, 0, 2**31 - 1]] * sets
    tag_s = rng.integers(0, 2 * min(ways, 40), n).astype(np.int32)
    return (tags, age, tag_s, acc.astype(np.int32), per_set, first)


@pytest.mark.parametrize("name", ["cold 128 ways", "equal ages", "ages wrap",
                                  "12 ways", "20 ways", "duplicate tags"])
def test_set_walk_emulation_edges(name):
    case = _walk_case(name)
    hit, want_tags, want_age = ref.set_walk_ref(
        *(torch.as_tensor(a) for a in case))
    tags, age, tag_s, acc_s, per_set, first = case
    tg, ag = tags.copy(), age.copy()
    got = np.zeros(tag_s.shape, bool)
    _emulate_set_walk(tg, ag, tag_s, acc_s, per_set, first, got)
    np.testing.assert_array_equal(got, hit.numpy())
    np.testing.assert_array_equal(tg, want_tags.numpy())
    np.testing.assert_array_equal(ag, want_age.numpy())


def _lane_case(name, suffix):
    """Explicit lane-scan edges through the host plan: ties on a cold
    cache of 128 ways, addresses near 2**31 - 1, a lane counter that
    reaches 2**31 - 1 (a stamp of INT32_MAX), one past it (stamps that
    wrap), strides that do not divide the block, 12 and 20 ways, masked
    lanes."""
    top = 2**31 - 1
    rng = np.random.default_rng(len(name))
    segs, geos, masks = None, [(4, 8, 64), (2, 4, 32)], None
    if name == "cold 128 ways":
        geos = [(2, 128, 64), (1, 128, 32)]
    elif name == "addresses near 2**31 - 1":
        segs = [(top - 4096 + int(rng.integers(0, 2048)), 8,
                 int(rng.integers(1, 200))) for _ in range(12)]
        segs = [(b, s_, min(c, (top - b) // s_)) for b, s_, c in segs]
    elif name in ("counter reaches 2**31 - 1", "stamps wrap"):
        extra = 1 if name == "stamps wrap" else 0
        segs = [(0, 1, top - 3000 - 4096)] + \
            [(int(rng.integers(0, 64)) * 16, 4, 64) for _ in range(64)]
        segs[-1] = (segs[-1][0], 4, top - sum(c for _, _, c in segs[:-1])
                    + extra)
        segs[-1] = (0, 1, segs[-1][2])
    elif name == "strides not dividing the block":
        segs = [(int(rng.integers(0, 128)) * 8, int(rng.choice([12, 20, 24])),
                 int(rng.integers(1, 90))) for _ in range(40)]
    elif name == "12 and 20 ways":
        geos = [(4, 12, 64), (2, 20, 32), (1, 12, 32)]
    elif name == "masked lanes":
        geos = [(4, 8, 64), (2, 8, 64), (4, 4, 64)]
        masks = rng.choice([0, 0x0F, 0x03, 0xF0, 0x81], (3, 40))
    if segs is None:
        segs = [(int(rng.integers(0, 96)) * 16, int(rng.choice([4, 8, 16])),
                 int(rng.integers(0, 120))) for _ in range(40)]
    sets, ways, bbs = (np.asarray(v, np.int64) for v in zip(*geos))
    b, s_, c = (np.asarray(v, np.int64)[None] for v in zip(*segs))
    nb = np.where(c > 0, (b + (c - 1) * s_) // bbs[:, None]
                  - b // bbs[:, None] + 1, 0)
    r_needed = np.minimum(ways[:, None], -(-nb // sets[:, None]))
    if masks is not None:
        masks = masks & ((1 << ways[:, None]) - 1)
        r_needed = np.where(masks != 0, -(-nb // sets[:, None]), r_needed)
    cold = np.zeros(c.shape, bool)
    cold[:, ::5] = True
    r_pad = max(1, int(r_needed.max()))
    table, rounds, geo, _ = cache._lane_plan_tables(
        b, s_, c, r_needed, cold, sets, ways, bbs, masks, r_pad=r_pad,
        suffix=suffix)
    return (table, rounds, geo, int(sets.max()), int(ways.max()), r_pad,
            suffix)


@pytest.mark.parametrize("suffix", ["none", "one", "full"])
@pytest.mark.parametrize("name", [
    "cold 128 ways", "addresses near 2**31 - 1", "counter reaches 2**31 - 1",
    "stamps wrap", "strides not dividing the block", "12 and 20 ways",
    "masked lanes"])
def test_lane_scan_emulation_edges(name, suffix):
    plan = _lane_case(name, suffix)
    _assert_lane_scan_equal(_emulated_lane_scan(*plan),
                            _plain_lane_scan(*plan))


def test_fig5_frame_in_one_launch_is_bucket_by_bucket_and_the_reference(
        monkeypatch):
    """``sweep.segment_lane_hit_counts`` over Fig. 5's 21 geometries (8
    lane buckets) on the frame's first 48 segments: one launch (stood in
    for by the emulation), whose every lane's hits are the
    bucket-by-bucket plan's (one plain replay a bucket, as before the
    one-launch plan) and the reference's."""
    from repro.core import sweep as j_sweep
    from repro.core.cache import LLCConfig as JLLCConfig

    from repro_torch.core import sweep, traces

    frame = [traces.segment_tuple(s) for s in traces.network_trace()[:48]]
    cfgs = list(sweep.grid_configs((0.5, 2, 8, 64, 512, 1024, 4096),
                                   (32, 64, 128)).values())
    want = np.zeros((len(cfgs), len(frame)), np.int64)
    for bucket in sweep.lane_buckets(cfgs):
        cfgs_b = [cfgs[i] for i in bucket]
        sets, ways, bbs, max_sets, max_ways = sweep._geometry_arrays(cfgs_b)
        b, s_, c = sweep._lane_meta_arrays([frame])
        r, cold = sweep._lane_plan(frame, cfgs_b)
        want[bucket] = cache.segment_lane_scan(
            b, s_, c, r[None], cold[None], sets, ways, bbs,
            max_sets=max_sets, max_ways=max_ways, r_pad=max_ways,
            device="cpu")
    ref_hits = j_sweep.segment_lane_hit_counts(
        frame, [JLLCConfig(c.size_bytes, c.ways, c.block_bytes)
                for c in cfgs])
    np.testing.assert_array_equal(want, np.asarray(ref_hits))

    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "lane_scan_ref", _no_plain)
    monkeypatch.setattr(K, "lane_scan_kernel", _lane_scan_stand_in(calls))
    got = sweep.segment_lane_hit_counts(frame, cfgs, device="cpu")
    assert calls == ["lane_scan"]
    assert len(sweep.lane_buckets(cfgs)) == 8
    np.testing.assert_array_equal(got, want)


def test_chip_smoke_llc_cases_cover_every_suffix_and_mask():
    """``chip_smoke.py``'s kernel checks draw their cases from
    ``llc_cases``: every suffix mode, masked and unmasked lanes, one
    set, lanes wider than one block of threads (``SCAN_THREADS`` in
    ``csrc/llc.cu``), a warm set walk, and buckets of 1, 16 and 4,096
    sets for one launch (``LLC_BUCKETS``)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    walks, lanes = chip_smoke.llc_cases(torch.device("cpu"))
    assert {c["suffix"] for c in lanes} == {"full", "one", "none"}
    assert any(c["masked"] for c in lanes)
    assert any(not c["masked"] for c in lanes)
    assert any(c["max_sets"] == 1 for c in lanes)
    assert any(c["max_sets"] > K.SCAN_THREADS for c in lanes)
    assert any(w["warm"] for w in walks)
    assert [lanes[i]["max_sets"] for i in chip_smoke.LLC_BUCKETS] == \
        [1, 16, 4096]
    for c in lanes:
        want = ref.lane_scan_ref(c["table"], c["rounds"], c["geo"],
                                 **c["kw"])
        assert want[0].shape == c["table"].shape[:2]
    buckets = [chip_smoke.lane_bucket(lanes[i])
               for i in chip_smoke.LLC_BUCKETS]
    for got, i in zip(ops.lane_scan_many(buckets, collect=True),
                      chip_smoke.LLC_BUCKETS):
        assert chip_smoke.llc_diff(got, ref.lane_scan_ref(
            lanes[i]["table"], lanes[i]["rounds"], lanes[i]["geo"],
            **lanes[i]["kw"])) == 0.0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@settings(max_examples=40, deadline=None, database=None)
@given(case=_arrivals())
def test_set_walk_kernel_is_the_plain_walk_on_card(case):
    dev = _card()
    args = [torch.as_tensor(a, device=dev) for a in case]
    before = K.set_walk_launches
    got = ops.set_walk(*args)
    want = ref.set_walk_ref(*args)
    torch.cuda.synchronize()
    assert K.set_walk_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@settings(max_examples=40, deadline=None, database=None)
@given(plan=_lane_plans(), collect=st.booleans())
def test_lane_scan_kernel_is_the_plain_scan_on_card(plan, collect):
    dev = _card()
    table, rounds, geo, max_sets, max_ways, r_pad, suffix = plan
    args = [torch.as_tensor(a, device=dev) for a in (table, rounds, geo)]
    kw = dict(max_sets=max_sets, max_ways=max_ways, r_pad=r_pad,
              collect=collect, suffix=suffix)
    before = K.lane_scan_launches
    got = ops.lane_scan(*args, **kw)
    want = ref.lane_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    assert K.lane_scan_launches == before + 1
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.gpu
@settings(max_examples=30, deadline=None, database=None)
@given(plans=st.lists(_lane_plans(), min_size=2, max_size=4),
       collect=st.booleans())
def test_lane_scan_many_kernel_is_each_plain_scan_on_card(plans, collect):
    """Several lane batches in one launch, each bit-equal to its own
    plain scan."""
    dev = _card()
    buckets = [tuple(torch.as_tensor(a, device=dev) for a in p[:3]) + p[3:]
               for p in plans]
    before = K.lane_scan_launches
    got = ops.lane_scan_many(buckets, collect=collect)
    torch.cuda.synchronize()
    assert K.lane_scan_launches == before + 1
    for g, (table, rounds, geo, max_sets, max_ways, r_pad, suffix) in zip(
            got, buckets):
        want = ref.lane_scan_ref(table, rounds, geo, max_sets=max_sets,
                                 max_ways=max_ways, r_pad=r_pad,
                                 collect=collect, suffix=suffix)
        for a, w in zip(g, want):
            assert (a is None and w is None) or torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cold 128 ways", "equal ages", "ages wrap",
                                  "12 ways", "20 ways", "duplicate tags"])
def test_set_walk_kernel_edges_on_card(name):
    dev = _card()
    args = [torch.as_tensor(a, device=dev) for a in _walk_case(name)]
    for g, w in zip(ops.set_walk(*args), ref.set_walk_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("suffix", ["none", "one", "full"])
@pytest.mark.parametrize("name", [
    "cold 128 ways", "addresses near 2**31 - 1", "counter reaches 2**31 - 1",
    "stamps wrap", "strides not dividing the block", "12 and 20 ways",
    "masked lanes"])
def test_lane_scan_kernel_edges_on_card(name, suffix):
    dev = _card()
    table, rounds, geo, *rest = _lane_case(name, suffix)
    args = [torch.as_tensor(a, device=dev) for a in (table, rounds, geo)]
    kw = dict(zip(("max_sets", "max_ways", "r_pad", "suffix"), rest),
              collect=True)
    got, want = ops.lane_scan(*args, **kw), ref.lane_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_engines_on_card_are_the_cpu_engines():
    """``core.cache``'s two engines on the card give the CPU route's
    results bit for bit (hits, miss runs, miss bits, state), and Fig. 5's
    21 geometries (8 lane buckets) on the frame's first 48 segments take
    one launch."""
    dev = _card()
    cfg = LLCConfig(8192, 8, 64)
    segs = _trace(3, n=200)
    got = cache.simulate_segments(segs, cfg, per_segment=True,
                                  collect_miss_runs=True, device=dev)
    want = cache.simulate_segments(segs, cfg, per_segment=True,
                                   collect_miss_runs=True, device="cpu")
    assert got.miss_runs == want.miss_runs
    np.testing.assert_array_equal(got.per_segment_hits,
                                  want.per_segment_hits)
    for a, w in zip(got.state, want.state):
        assert torch.equal(a.cpu(), w)
    lane = [s for s in segs if s[1] <= 32]
    b, s_, c = (np.asarray(v, np.int64)[None] for v in zip(*lane))
    args = (b, s_, c, np.full(b.shape[1], 8), np.zeros(b.shape[1], bool),
            [16, 8], [8, 4], [64, 128])
    kw = dict(max_sets=16, max_ways=8, r_pad=8, collect=True,
              return_state=True)
    got = cache.segment_lane_scan(*args, **kw, device=dev)
    want = cache.segment_lane_scan(*args, **kw, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for a, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, w)
    from repro_torch.core import sweep, traces

    frame = traces.network_trace()[:48]
    cfgs = list(sweep.grid_configs((0.5, 2, 8, 64, 512, 1024, 4096),
                                   (32, 64, 128)).values())
    before = K.lane_scan_launches
    got = sweep.segment_lane_hit_counts(frame, cfgs, device=dev)
    assert K.lane_scan_launches == before + 1
    np.testing.assert_array_equal(
        got, sweep.segment_lane_hit_counts(frame, cfgs, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_dbb_stream_on_card_is_one_walk_and_the_plain_replay(seed):
    """``socsim.simulate_dbb_stream`` on the card makes one set-walk
    launch and gives the CPU route's (the generic pipeline's) latencies,
    total and host cycles under seeded random stalls, and its final LLC
    and DRAM states."""
    from repro_torch.core import fame1, socsim
    from repro_torch.core.dram import DRAMConfig

    dev = _card()
    rng = np.random.default_rng(seed)
    addrs = np.concatenate([rng.integers(0, 1 << 16, 600) * 32,
                            rng.integers(0, 1 << 35, 200) * 32])
    stalls = rng.random((3 * addrs.shape[0], 2)) < 0.35
    llc = LLCConfig(16384, 4, 64)
    for early_exit in (True, False):
        before = K.set_walk_launches
        got = socsim.simulate_dbb_stream(addrs, llc=llc, host_stalls=stalls,
                                         early_exit=early_exit, device=dev)
        assert K.set_walk_launches == before + 1
        want = socsim.simulate_dbb_stream(addrs, llc=llc, host_stalls=stalls,
                                          early_exit=early_exit, device="cpu")
        assert torch.equal(got.latencies.cpu(), want.latencies)
        assert int(got.total_cycles) == int(want.total_cycles)
        assert got.host_cycles == want.host_cycles
        a = torch.as_tensor(addrs)
        fires, drained, _ = fame1.plan_schedule(
            a.shape[0], 2, stalls, stalls.shape[0], early_exit=early_exit)
        (tags, age), rows = socsim._stream_on_card(
            a.to(dev), llc, DRAMConfig(), fires, drained)[0]
        pipe = fame1.FAME1Pipeline([
            socsim.llc_component(llc, device="cpu"),
            socsim.dram_component(llc, DRAMConfig(), device="cpu")])
        ((w_tags, w_age), w_rows), _, _ = pipe.run(
            a, host_stalls=stalls, max_host_cycles=stalls.shape[0],
            early_exit=early_exit)
        for g, w in ((tags, w_tags), (age, w_age), (rows, w_rows)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_padded_lanes_on_card_are_the_plain_loop():
    """``sweep.batched_hits`` on the card makes one set walk a distinct
    way count and equals the plain per-access loop on the CPU, on
    Fig. 5's 21 geometries over a 4,096-burst window."""
    import warnings

    from repro_torch.core import sweep, traces

    dev = _card()
    addrs = traces.expand(traces.default_dbb_window(max_bursts=4096))
    cfgs = list(sweep.grid_configs((0.5, 2, 8, 64, 512, 1024, 4096),
                                   (32, 64, 128)).values())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        before = K.set_walk_launches
        got = sweep.batched_hits(addrs, cfgs, device=dev)
        assert K.set_walk_launches == before + len({c.ways for c in cfgs})
        want = sweep.batched_hits(addrs, cfgs, device="cpu")
    np.testing.assert_array_equal(got, want)

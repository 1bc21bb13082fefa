"""The LLC replay kernels (``csrc/llc.cu``) and their plain versions.

``_emulate_set_walk`` and ``_emulate_lane_scan`` are numpy copies of
the kernels' walks and are the spec to keep in step with
``csrc/llc.cu``: the set walk a warp of 32 sets walking staged chunks
of 32 arrivals, the victim by the first-index argmax tree; the lane
scan every thread of the block table (``kernel.launch_plan``: one
launch for every lane bucket) running the kernel's 32-bit arithmetic,
divisions by a reciprocal (``_fastdiv``), the round's tag t0 + k, the
argmin tree, the suffix's ranks taken mod ways without a division.
Past 128 ways the warp routes: a warp a set or a (bucket, lane, set),
way q on lane q % 32, the lanes' first best keys and the warp's pick
by two reductions (``_warp_pick``), the suffix's ranks by the bitonic
network over (stamp, way) keys (``_bitonic_ranks``), a call of both
widths as two launches (``kernel.route_plans``).  Int32 sums wrap as
uint32.  On the CPU they are held bit for bit to the
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
    """The thread routes' compile-time way bound for ``ways`` (their
    dispatch, up to ``K.THREAD_WAYS``)."""
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


def _warp_pick(keys, better):
    """The warp routes' pick over one set's ``keys`` (a key a way, way q
    on lane q % 32): each lane's first best over its own ways in order,
    then the best key over the lanes (``__reduce_max_sync`` /
    ``__reduce_min_sync``) and the least way among the lanes holding it
    (``__reduce_min_sync``); a lane with no way votes for none.  Returns
    (way, key)."""
    lane_key, lane_way = [], []
    for lane in range(min(32, keys.shape[0])):
        own = keys[lane::32]
        k = int(np.argmax(own) if better is np.greater else np.argmin(own))
        lane_key.append(int(own[k]))
        lane_way.append(lane + 32 * k)
    best = max(lane_key) if better is np.greater else min(lane_key)
    return min(w for k, w in zip(lane_key, lane_way) if k == best), best


def _emulate_set_walk_warp(tags, age, tag_s, acc_s, per_set, first, hit_s):
    """``llc_set_walk_warp_kernel`` / ``llc_set_walk_mem_kernel`` (ways
    past ``K.THREAD_WAYS``): a warp a set takes its arrivals in order
    (staged 32 at a time and broadcast, which orders nothing), scores
    each way (INT32_MAX for a matching tag, else its age), touches the
    warp's pick (``_warp_pick``: the first way of the greatest score),
    ages every other way by the access count (wrapping as int32), and
    the hit is any lane's match.  The state's place (registers, shared
    or global memory) changes no value."""
    sets, ways = tags.shape
    for s in range(sets):
        tg, ag = tags[s].astype(np.int64), age[s].astype(np.int64)
        for r in range(int(first[s]), int(first[s] + per_set[s])):
            t, a = int(tag_s[r]), int(acc_s[r]) & M32
            match = tg == t
            way, _ = _warp_pick(np.where(match, IMAX, ag), np.greater)
            ag = np.where(np.arange(ways) == way, 0, _i32(ag + a))
            tg[way] = t
            hit_s[r] = bool(match.any())
        tags[s], age[s] = tg, ag


def _emulate_set_walk(tags, age, tag_s, acc_s, per_set, first, hit_s):
    """``llc_set_walk_kernel``: a block of 32 lanes walks 32 sets; each
    chunk of 32 arrivals a set is staged, walked (scores: INT32_MAX for a
    matching tag, the age otherwise, IMIN past the real ways; the argmax
    tree), and its hit bits written out; tags / age (sets, ways) int32
    walked in place, hit_s (n,) bool written.  Sets wider than
    ``K.THREAD_WAYS`` take the warp route (``_emulate_set_walk_warp``)."""
    sets, ways = tags.shape
    if ways > K.THREAD_WAYS:
        return _emulate_set_walk_warp(tags, age, tag_s, acc_s, per_set,
                                      first, hit_s)
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
    width = _template_ways(max(buckets[b][3]["max_ways"]
                               for b in set(blocks[:, 0].tolist())))
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
        if not m.any():   # a bucket of the other route
            continue
        mw = buckets[b][3]["max_ways"]
        at = (ln[m][:, None], np.arange(mw)[None, :], s[m][:, None])
        tags[at], ts[at] = tg[m, :mw], np.where(real[m, :mw], st[m, :mw], 0)


def _bitonic_ranks(st):
    """The warp route's suffix ranks: the kernel's bitonic network, pass
    by pass (a pass's pairs are disjoint), sorting pow2(ways) 64-bit keys
    ascending ((stamp ^ 0x80000000) << 32 | way; the padding keys all
    ones, last).  Returns the way of each rank."""
    ways = st.shape[0]
    span = 1 << max(0, ways - 1).bit_length()
    keys = np.full(span, 2**64 - 1, np.uint64)
    keys[:ways] = (((st.astype(np.int64) & M32) ^ 0x80000000).astype(
        np.uint64) << np.uint64(32)) | np.arange(ways, dtype=np.uint64)
    x = np.arange(span // 2)
    k2 = 2
    while k2 <= span:
        jj = k2 >> 1
        while jj > 0:
            i = ((x & ~(jj - 1)) << 1) | (x & (jj - 1))
            ixj = i | jj
            u, v = keys[i], keys[ixj]
            swap = (u > v) == ((i & k2) == 0)
            keys[i], keys[ixj] = np.where(swap, v, u), np.where(swap, u, v)
            jj >>= 1
        k2 <<= 1
    return (keys[:ways] & np.uint64(M32)).astype(np.int64)


def _emulate_lane_scan_warp(buckets, blocks, outs):
    """``llc_lane_scan_wide_kernel`` over the block table ``blocks`` ((n,
    3): bucket, lane, set), one warp a row walking its lane's real ways
    only (padding ways are written out as -1 / 0): the kernel's 32-bit
    arithmetic (``derive``, the reciprocal divisions), the round's key
    (-1 for a match, the stamp where the int64 mask allows the way, its
    sign bit past bit 63, else INT32_MAX) and the warp's pick
    (``_warp_pick``), the suffix's one eviction by the same pick and its
    ranks by the bitonic network (``_bitonic_ranks``)."""
    def div(n, d):
        mul, shift = _fastdiv(d)
        return (((n * mul) >> 32) + n) >> shift

    for b, l, s in blocks.tolist():
        table, rnd, geo, sz = buckets[b]
        hits, miss, tags_out, ts_out = outs[b]
        sets, ways, bb = (int(v) for v in geo[l])
        q = np.arange(ways)
        tg = np.full(ways, -1, np.int64)
        st = np.zeros(ways, np.int64)
        active = s < sets
        step = sets * bb & M32
        for j in range(sz["n_seg"]):
            base, stride, count, b_first, n_pre, sb_first, n_suf, counter, \
                wsel = (int(v) for v in table[l, j])
            counter &= M32
            b_first, sb_first = b_first & M32, sb_first & M32
            qb = div(b_first, sets)
            ub = b_first - qb * sets
            by_stride = stride if stride > 0 else 1

            def last(x):   # last_access
                return min(div(x & M32, by_stride), (count - 1) & M32)

            alloc = (wsel == 0) | np.where(
                q < 64, (wsel >> np.minimum(q, 63)) & 1, wsel < 0).astype(bool)
            if rnd[j] > 0:
                mine = 0
                if active:
                    wrap = s < ub
                    i = s + sets - ub if wrap else s - ub
                    t = qb + wrap
                    lo = ((b_first + i) * bb - base) & M32
                    k = 0
                    while k < rnd[j] and i < n_pre:
                        j_hi = last(lo + bb - 1)
                        j_lo = 0 if _i32(lo) <= 0 else div(
                            (lo + stride - 1) & M32, by_stride)
                        key = np.where(tg == t, -1, np.where(alloc, st, IMAX))
                        way, kmin = _warp_pick(key, np.less)
                        hit = kmin == -1
                        tg[way], st[way] = t, _i32(counter + j_hi + 1)
                        mine = (mine + j_hi - j_lo + hit) & M32
                        if miss is not None and not hit:
                            miss[l, j, k, s] = True
                        k, i, t, lo = k + 1, i + sets, t + 1, (lo + step) & M32
                hits[l, j] += mine
            if not active or sz["suffix"] == 0 or n_suf <= 0:
                continue
            qsb = div(sb_first, sets)
            usb = sb_first - qsb * sets
            wrap = s < usb
            off_suf = s + sets - usb if wrap else s - usb
            if off_suf >= n_suf:
                continue
            t_suf, blk0 = qsb + wrap, (sb_first + off_suf) & M32

            def stamp(blk):
                return _i32(counter + last(blk * bb - base + bb - 1) + 1)

            if sz["suffix"] == 1:
                way, _ = _warp_pick(st, np.less)
                tg[way], st[way] = t_suf, stamp(blk0)
                continue
            m = div((n_suf - off_suf + sets - 1) & M32, sets)
            e = (m - 1) & M32
            e -= div(e, ways) * ways
            for r, a in enumerate(_bitonic_ranks(st).tolist()):
                dd = e - r if e >= r else e + ways - r
                if dd < m:
                    back = m - 1 - dd
                    tg[a] = t_suf + back
                    st[a] = stamp((blk0 + back * sets) & M32)
        mw = sz["max_ways"]
        tags_out[l, :, s] = np.concatenate([tg, np.full(mw - ways, -1)])
        ts_out[l, :, s] = np.concatenate([st, np.zeros(mw - ways, np.int64)])


def _emulate_launches(buckets, outs, depths):
    """``kernel.lane_scan_kernel``'s launches (``kernel.route_plans``):
    the thread route over the narrow buckets, then the warp route over
    the wide ones.  Returns the routes launched."""
    sizes = [b[3] for b in buckets]
    routes = []
    for wide, _, blocks in K.route_plans(sizes, depths):
        (_emulate_lane_scan_warp if wide else _emulate_lane_scan)(
            buckets, blocks, outs)
        routes.append("warp" if wide else "thread")
    return routes


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
    """Stands in for ``kernel.lane_scan_kernel``: its launches emulated,
    one call noted a launch ("lane_scan"; "lane_scan warp" for the warp
    route's)."""
    def launch(plans, outs, depths):
        routes = _emulate_launches(
            [(p[0].numpy(), p[1].numpy(), p[2].numpy(), p[3]) for p in plans],
            [tuple(None if o is None else o.numpy() for o in out)
             for out in outs], depths)
        calls.extend("lane_scan" + (" warp" if r == "warp" else "")
                     for r in routes)
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


WIDE_WAYS = [129, 160, 256, 1024]   # past the thread routes' 128


@st.composite
def _wide_arrivals(draw):
    """Set-sorted arrivals of a geometry past ``K.THREAD_WAYS``: 1-2
    sets of 129, 160, 256 or 1,024 ways, each set past its capacity
    (from 1.5x its ways in distinct tags, so that victims are chosen),
    a cold state or a warm one with ages over all of int32, access
    counts small or up to 2**31 - 1 (sums wrap)."""
    sets = draw(st.sampled_from([1, 2]))
    ways = draw(st.sampled_from(WIDE_WAYS))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    per_set = rng.integers(ways, 2 * ways + 1, sets)
    n = int(per_set.sum())
    first = np.cumsum(per_set) - per_set
    span = 3 * ways // 2
    if draw(st.booleans()):
        tags = rng.integers(-1, span, (sets, ways)).astype(np.int32)
        age = rng.integers(-2**31, 2**31, (sets, ways)).astype(np.int32)
    else:
        tags = np.full((sets, ways), -1, np.int32)
        age = np.zeros((sets, ways), np.int32)
    tag_s = rng.integers(0, span, n).astype(np.int32)
    acc_s = rng.integers(1, 2**31 if draw(st.booleans()) else 40,
                         n).astype(np.int32)
    return tags, age, tag_s, acc_s, per_set, first


@st.composite
def _wide_lane_plans(draw):
    """A lane batch past ``K.THREAD_WAYS`` through the host plan: 1-2
    lanes of 129, 160, 256 or 1,024 ways (a narrow lane of 8 ways beside
    them in the same bucket), 1-4 sets, blocks of 32/64 bytes, streams
    that overflow the sets, cold flags, masks including negative ones
    (the sign bit allocates every way past bit 63), every suffix mode."""
    geos = [(draw(st.sampled_from([1, 2, 4])), draw(st.sampled_from(
        WIDE_WAYS)), draw(st.sampled_from([32, 64])))
        for _ in range(draw(st.integers(1, 2)))]
    if draw(st.booleans()):
        geos.append((draw(st.sampled_from([1, 2])), 8, 64))
    sets, ways, bbs = (np.asarray(v, np.int64) for v in zip(*geos))
    n_lane, n_seg = len(geos), draw(st.integers(2, 8))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    span = int((sets * ways * bbs).max()) * 3 // 2
    bases = rng.integers(0, span // 16, (1, n_seg)) * 16
    strides = rng.choice([4, 8, 16, 32], (1, n_seg))
    counts = rng.integers(0, span // 8, (1, n_seg))
    counts[rng.random((1, n_seg)) < 0.15] = 0
    cold = rng.random((1, n_seg)) < 0.3
    way_sels = None
    if draw(st.booleans()):
        pick = rng.integers(0, 4, (n_lane, n_seg))
        low = rng.integers(1, 2**62, (n_lane, n_seg))
        way_sels = np.where(pick == 0, 0, np.where(pick == 1, -low, low))
    shape = (n_lane, n_seg)
    b, s_, c = (np.broadcast_to(a, shape) for a in (bases, strides, counts))
    nb = np.where(c > 0, (b + (c - 1) * s_) // bbs[:, None]
                  - b // bbs[:, None] + 1, 0)
    r_needed = np.minimum(ways[:, None], -(-nb // sets[:, None]))
    if way_sels is not None:
        r_needed = np.where(way_sels != 0, -(-nb // sets[:, None]),
                            r_needed)
    r_pad = max(1, int(r_needed.max()))
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
    call: the block tables of its routes, then the kernels' threads and
    warps."""
    sizes = [_sizes(*p) for p in plans]
    outs = [_launch_outs(sz, collect) for sz in sizes]
    _emulate_launches([(p[0], p[1], p[2], sz) for p, sz in zip(plans, sizes)],
                      outs, [int(np.sum(p[1])) for p in plans])
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


@settings(max_examples=12, deadline=None, database=None)
@given(case=_wide_arrivals())
def test_warp_set_walk_emulation_is_the_plain_walk(case):
    """The set walk's warp route (ways past 128): the lanes' first
    greatest scores and the warp's first way among them, over sets past
    their capacity, bit for bit the plain walk's hits and state."""
    hit, want_tags, want_age = ref.set_walk_ref(
        *(torch.as_tensor(a) for a in case))
    tags, age, tag_s, acc_s, per_set, first = case
    tg, ag = tags.copy(), age.copy()
    got = np.zeros(tag_s.shape, bool)
    _emulate_set_walk(tg, ag, tag_s, acc_s, per_set, first, got)
    np.testing.assert_array_equal(got, hit.numpy())
    np.testing.assert_array_equal(tg, want_tags.numpy())
    np.testing.assert_array_equal(ag, want_age.numpy())


@settings(max_examples=15, deadline=None, database=None)
@given(plan=_wide_lane_plans(), collect=st.booleans())
def test_warp_lane_scan_emulation_is_the_plain_scan(plan, collect):
    """The lane scan's warp route: the warp's argmin with first-index
    ties, negative masks, and the suffix ranks by the bitonic network,
    bit for bit the plain scan's hits, miss bits and state."""
    want = _plain_lane_scan(*plan, collect=collect)
    _assert_lane_scan_equal(_emulated_lane_scan(*plan), want, collect)


@settings(max_examples=8, deadline=None, database=None)
@given(narrow=_lane_plans(), wide=_wide_lane_plans())
def test_one_call_of_narrow_and_wide_buckets_is_two_launches(narrow, wide):
    """A call that holds buckets of both widths launches the thread
    route, then the warp route, and each bucket is its own plain scan."""
    sizes = [_sizes(*p) for p in (narrow, wide, narrow)]
    routes = [w for w, _, _ in K.route_plans(sizes, [3, 1, 2])]
    assert routes == [False, True]
    got = _emulated_lane_scan_many([narrow, wide, narrow])
    for g, plan in zip(got, (narrow, wide, narrow)):
        _assert_lane_scan_equal(g, _plain_lane_scan(*plan))


def test_bitonic_ranks_are_the_stable_oldest_first_order():
    """The warp route's suffix ranks: ascending stamps, ties on the lower
    way, over all of int32 and at way counts that are and are not powers
    of two."""
    rng = np.random.default_rng(31)
    for ways in (1, 2, 3, 129, 160, 256, 1000, 1024):
        for st_ in (rng.integers(-2**31, 2**31, ways),
                    rng.integers(0, 4, ways),
                    np.full(ways, 2**31 - 1), np.full(ways, -2**31)):
            want = np.lexsort((np.arange(ways), st_))
            np.testing.assert_array_equal(_bitonic_ranks(st_), want)


def test_warp_pick_takes_the_first_index_of_the_extreme():
    """The warp's two reductions give the plain argmax / argmin's first
    index, ties across lanes and within a lane alike."""
    rng = np.random.default_rng(7)
    for ways in (129, 160, 256, 1024):
        for keys in (rng.integers(0, 3, ways), np.zeros(ways, np.int64),
                     rng.integers(-2**31, 2**31, ways)):
            assert _warp_pick(keys, np.greater) == (int(np.argmax(keys)),
                                                    int(keys.max()))
            assert _warp_pick(keys, np.less) == (int(np.argmin(keys)),
                                                 int(keys.min()))


def test_route_bounds():
    """The set walk's routes by way count and the lane scan's slot: in
    shared memory while it fits a block's, else a global scratch slot a
    (bucket, lane, set)."""
    assert [K.set_walk_route(w) for w in (1, 128, 129, 256, 257, 29056,
                                          29057)] == [
        "thread", "thread", "registers", "registers", "shared", "shared",
        "global"]
    assert K.wide_slot_bytes(129) == 8 * 130 + 8 * 256
    assert K.wide_slot_bytes(1024) == 8 * 1024 * 2
    sz = dict(lanes=2, max_sets=3)
    assert K.wide_scratch_bytes([dict(sz, max_ways=128)]) == 0
    assert K.wide_scratch_bytes([dict(sz, max_ways=4096)]) == 0
    assert K.wide_slot_bytes(12672) <= K.SHARED_BYTES \
        < K.wide_slot_bytes(12673)
    assert K.wide_scratch_bytes([dict(sz, max_ways=14600),
                                 dict(sz, max_ways=8)]) == \
        6 * K.wide_slot_bytes(14600)


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


def _card_route(monkeypatch, calls):
    """The ops see a CUDA device; the kernels' emulations launch; the
    plain loops may not run."""
    monkeypatch.setattr(cache, "_on_card", lambda x: True)
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "set_walk_ref", _no_plain)
    monkeypatch.setattr(ref, "lane_scan_ref", _no_plain)
    monkeypatch.setattr(K, "set_walk_kernel", _set_walk_stand_in(calls))
    monkeypatch.setattr(K, "lane_scan_kernel", _lane_scan_stand_in(calls))


@pytest.mark.parametrize("ways", WIDE_WAYS)
@pytest.mark.parametrize("engine", ["set_walk", "lane_scan"])
def test_cuda_route_runs_wide_ways_through_the_warp_routes(monkeypatch,
                                                           engine, ways):
    """Past 128 ways a CUDA tensor takes the warp routes (one launch of
    each engine; stood in for by the emulations), never the plain loops,
    and their results are the CPU route's bit for bit."""
    # past the capacity (2 sets): a long run, a revisit, a random tail
    segs = [(0, 64, 3 * ways), (64 * ways, 32, 4 * ways),
            (0, 64, 2 * ways)] + _trace(ways, n=20)
    cfg = LLCConfig(64 * ways * 2, ways, 64)
    lane_segs = [s for s in segs if s[1] <= 32]
    b, s_, c = (np.asarray(v, np.int64) for v in zip(*lane_segs))
    lane_args = ([[0] * 3 + list(b)], [[16] * 3 + list(s_)],
                 [[12000] * 3 + list(c)], np.full(b.shape[0] + 3, ways),
                 np.zeros(b.shape[0] + 3, bool), [2, 1], [ways, 129],
                 [64, 32])
    lane_kw = dict(max_sets=2, max_ways=ways, r_pad=ways, collect=True,
                   return_state=True, device="cpu")

    def run():
        if engine == "set_walk":
            res = cache.simulate_segments(segs, cfg, per_segment=True,
                                          collect_miss_runs=True,
                                          device="cpu")
            return [res.per_segment_hits, res.miss_runs,
                    *(t.numpy() for t in res.state)]
        hits, miss, (tags, ts) = cache.segment_lane_scan(*lane_args,
                                                         **lane_kw)
        return [hits, miss, tags, ts]

    want = run()
    calls = []
    _card_route(monkeypatch, calls)
    got = run()
    assert calls == (["set_walk"] if engine == "set_walk"
                     else ["lane_scan warp"])
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["set_walk", "lane_scan"])
def test_cuda_route_raises_past_the_cards_memory(monkeypatch, engine):
    """What is left of a width limit on the card is its memory: the ops
    hold their allocations (the set walk's state, the lane scan's miss
    bits (L, S, r_pad, max_sets) at r_pad = max_ways) to the free bytes
    before any allocation or launch, and name them."""
    from repro_torch.utils import env

    calls = []
    _card_route(monkeypatch, calls)
    monkeypatch.setattr(env, "free_device_bytes", lambda dev: 10_000)
    monkeypatch.setattr(ops, "check_device_memory", lambda dev, n, what:
                        env.check_device_memory(torch.device("cuda"), n,
                                                what))
    ways = 4096
    with pytest.raises(MemoryError, match="set_walk's state" if engine ==
                       "set_walk" else "miss bits"):
        if engine == "set_walk":
            cache.simulate_segments([(0, 64, 4)], LLCConfig(64 * ways, ways,
                                                            64),
                                    device="cpu")
        else:
            cache.segment_lane_scan([[0]], [[64]], [[4]], [1], [False], [1],
                                    [ways], [64], max_sets=1, max_ways=ways,
                                    r_pad=ways, collect=True, device="cpu")
    assert calls == []


def test_kernels_raise_past_int32_indexing():
    """The other limit: every count the kernels index (ways, sets,
    arrivals, segments, blocks) stays under 2**31 - 32, and the wrappers
    raise, naming it, before a launch."""
    for name in ("ways", "sets", "arrivals", "blocks"):
        with pytest.raises(ValueError, match=f"int32: .* {name}"):
            K.check_int32(**{name: 2**31})
    K.check_int32(ways=2**31 - 33)
    table = torch.zeros((1, 1, len(K.FIELDS)), dtype=torch.int64)
    rounds = torch.zeros(1, dtype=torch.int32)
    geo = torch.ones((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32: .* ways"):
        K.bucket_sizes(table, rounds, geo, max_sets=1, max_ways=2**31,
                       r_pad=1, suffix="full")
    with pytest.raises(ValueError, match=r"int32: .* \(lane, set\) blocks"):
        K.bucket_sizes(table.expand(2**16, 1, -1), rounds,
                       geo.expand(2**16, 3), max_sets=2**16, max_ways=8,
                       r_pad=1, suffix="full")


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


@pytest.mark.gpu
@settings(max_examples=20, deadline=None, database=None)
@given(case=_wide_arrivals())
def test_warp_set_walk_kernel_is_the_plain_walk_on_card(case):
    """The set walk's warp route (registers up to 256 ways, shared memory
    past them) on the card, one launch, bit-equal to the plain walk."""
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
@pytest.mark.parametrize("ways", [300, 4096, 30000])
def test_set_walk_kernel_in_shared_and_global_memory_on_card(ways):
    """A set in shared memory (300 and 4,096 ways) and one past a block's
    shared memory, walked in place in global memory (30,000 ways): warm
    sets with ages over all of int32, so that victims are chosen."""
    dev = _card()
    rng = np.random.default_rng(ways)
    sets, n = 2, 2000
    per_set = np.array([n, n])
    case = (rng.integers(0, 2 * ways, (sets, ways)).astype(np.int32),
            rng.integers(-2**31, 2**31, (sets, ways)).astype(np.int32),
            rng.integers(0, 2 * ways, 2 * n).astype(np.int32),
            rng.integers(1, 2**31, 2 * n).astype(np.int32), per_set,
            np.cumsum(per_set) - per_set)
    assert K.set_walk_route(ways) == ("global" if ways == 30000
                                      else "shared")
    args = [torch.as_tensor(a, device=dev) for a in case]
    for g, w in zip(ops.set_walk(*args), ref.set_walk_ref(*args)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@settings(max_examples=15, deadline=None, database=None)
@given(plan=_wide_lane_plans(), collect=st.booleans())
def test_warp_lane_scan_kernel_is_the_plain_scan_on_card(plan, collect):
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
@settings(max_examples=8, deadline=None, database=None)
@given(narrow=_lane_plans(), wide=_wide_lane_plans())
def test_narrow_and_wide_buckets_on_card_are_two_launches(narrow, wide):
    dev = _card()
    buckets = [tuple(torch.as_tensor(a, device=dev) for a in p[:3]) + p[3:]
               for p in (narrow, wide)]
    before = K.lane_scan_launches
    got = ops.lane_scan_many(buckets, collect=True)
    torch.cuda.synchronize()
    assert K.lane_scan_launches == before + 2
    for g, (table, rounds, geo, max_sets, max_ways, r_pad, suffix) in zip(
            got, buckets):
        want = ref.lane_scan_ref(table, rounds, geo, max_sets=max_sets,
                                 max_ways=max_ways, r_pad=r_pad,
                                 collect=True, suffix=suffix)
        for a, w in zip(g, want):
            assert torch.equal(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("suffix", ["full", "one"])
def test_warp_lane_scan_in_global_slots_on_card(suffix):
    """A slot past a block's shared memory (13,000 ways: its sort keys
    and state in a global scratch), over a stream that overflows it."""
    dev = _card()
    ways = 13000
    assert K.wide_slot_bytes(ways) > K.SHARED_BYTES
    # two cold runs past the set, then a revisit of 4,000 blocks
    segs = [(0, 32, 30000), (64 * 20000, 16, 40000), (0, 64, 4000)]
    b, s_, c = (np.asarray(v, np.int64)[None] for v in zip(*segs))
    nb = (b + (c - 1) * s_) // 64 - b // 64 + 1
    cold = np.array([[True, True, False]])
    table, rounds, geo, _ = cache._lane_plan_tables(
        b, s_, c, np.where(cold, 0, np.minimum(nb, ways)), cold, [1], [ways],
        [64], r_pad=ways, suffix=suffix)
    args = [torch.as_tensor(a, device=dev) for a in (table, rounds, geo)]
    kw = dict(max_sets=1, max_ways=ways, r_pad=ways, collect=True,
              suffix=suffix)
    for g, w in zip(ops.lane_scan(*args, **kw), ref.lane_scan_ref(*args,
                                                                  **kw)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("sets, ways", [(512, 8), (16, 256), (4, 1024),
                                        (1, 200), (1, 4096)])
def test_simulate_trace_on_card_is_one_set_walk_and_the_plain_loop(sets,
                                                                   ways):
    """``cache.simulate_trace`` on the card: one ``llc_set_walk`` launch,
    no per-access host loop, the plain loop's hits on a trace past the
    capacity (victims chosen)."""
    dev = _card()
    blocks = np.random.default_rng(ways).integers(0, 3 * sets * ways // 2,
                                                  4 * sets * ways // 2)
    before = K.set_walk_launches
    got = cache.simulate_trace(blocks, sets=sets, ways=ways, device=dev)
    assert K.set_walk_launches == before + 1
    want = cache.simulate_trace(blocks, sets=sets, ways=ways, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.shape[0]

"""The LLC replay kernels (``csrc/llc.cu``) and their plain versions.

``_emulate_set_walk`` and ``_emulate_lane_scan`` are numpy copies of
the kernels' per-thread walks — one thread a set, one a (lane, set),
ways scanned in ascending order with strict comparisons, int32 sums
wrapped as uint32, int64 floor division — and are the spec to keep in
step with ``csrc/llc.cu``.  On the CPU they are held bit for bit to the
plain versions (``kernels/llc/ref.py``, the loops ``core/cache.py`` ran)
over hypothesis-drawn arrivals, traces and geometries, and stand in for
the kernels to show that a CUDA tensor takes the kernel route through
``core.cache`` and never the plain loop.  The ``gpu`` cases hold the
built kernels to the plain versions on the card, bit for bit.
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


def _i32(x: int) -> int:
    """An int wrapped to int32, as a uint32 sum cast back."""
    return (x + 2**31) % 2**32 - 2**31


# --------------------------------------------------------------------------
# the spec: llc.cu's walks in numpy
# --------------------------------------------------------------------------
def _emulate_set_walk(tags, age, tag_s, acc_s, per_set, first, hit_s):
    """``llc_set_walk_kernel``: thread s walks its set's arrivals; tags /
    age (sets, ways) int32 walked in place, hit_s (n,) bool written."""
    sets, ways = tags.shape
    for s in range(sets):
        tg, ag = tags[s].tolist(), age[s].tolist()
        f = int(first[s])
        for r in range(int(per_set[s])):
            t, a = int(tag_s[f + r]), int(acc_s[f + r]) % 2**32
            hit, way, best = False, 0, 0
            for q in range(ways):
                match = tg[q] == t
                hit |= match
                score = IMAX if match else ag[q]
                if q == 0 or score > best:
                    best, way = score, q
            for q in range(ways):
                if q == way:
                    tg[q], ag[q] = t, 0
                else:
                    ag[q] = _i32(ag[q] + a)
            hit_s[f + r] = hit
        tags[s], age[s] = tg, ag


def _last_access(blk, base, stride, count, bb):
    return min(count - 1, (blk * bb - base + bb - 1) // stride)


def _emulate_lane_scan(table, rounds, geo, tags, ts, hits, miss, r_pad,
                       suffix):
    """``llc_lane_scan_kernel``: thread (l, s) walks every segment of lane
    l over set s; tags / ts (L, max_ways, max_sets) walked in place, hits
    (L, S) added to, miss (L, S, r_pad, max_sets) set (or None)."""
    n_lane, n_seg, _ = table.shape
    _, max_ways, max_sets = tags.shape
    for l in range(n_lane):
        sets, ways, bb = (int(v) for v in geo[l])
        for s in range(min(sets, max_sets)):
            tg, tt = tags[l, :, s].tolist(), ts[l, :, s].tolist()
            for j in range(n_seg):
                (base, stride, count, b_first, n_pre, sb_first, n_suf,
                 counter, wsel) = (int(v) for v in table[l, j])
                off = (s - b_first) % sets
                for k in range(int(rounds[j])):
                    i = off + k * sets
                    if i >= n_pre:
                        continue
                    block = b_first + i
                    t = _i32(block // sets)
                    lo = block * bb - base
                    j_lo = 0 if lo <= 0 else (lo + stride - 1) // stride
                    j_hi = _last_access(block, base, stride, count, bb)
                    way, kmin = 0, 0
                    for q in range(max_ways):
                        alloc = q < ways and (wsel == 0 or (wsel >> q) & 1)
                        key = -1 if tg[q] == t else (tt[q] if alloc else IMAX)
                        if q == 0 or key < kmin:
                            kmin, way = key, q
                    hit = kmin == -1
                    tg[way], tt[way] = t, _i32(counter + j_hi + 1)
                    hits[l, j] += j_hi - j_lo + hit
                    if miss is not None and not hit:
                        miss[l, j, k, s] = True
                if suffix == "none" or n_suf <= 0:
                    continue
                off_suf = (s - sb_first) % sets
                vt = [tt[q] if q < ways else IMAX for q in range(max_ways)]
                if suffix == "one":
                    if off_suf >= n_suf:
                        continue
                    way = min(range(max_ways), key=lambda q: (vt[q], q))
                    blk = sb_first + off_suf
                    tg[way] = _i32(blk // sets)
                    tt[way] = _i32(counter + _last_access(
                        blk, base, stride, count, bb) + 1)
                    continue
                m = ((n_suf - off_suf + sets - 1) // sets
                     if off_suf < n_suf else 0)
                for a in range(min(max_ways, ways)):
                    rank = sum(vt[b] < vt[a] or (vt[b] == vt[a] and b < a)
                               for b in range(max_ways))
                    jstar = m - (m - 1 - rank) % ways
                    if jstar < 1:
                        continue
                    blk = sb_first + off_suf + (jstar - 1) * sets
                    tg[a] = _i32(blk // sets)
                    tt[a] = _i32(counter + _last_access(
                        blk, base, stride, count, bb) + 1)
            tags[l, :, s], ts[l, :, s] = tg, tt


def _set_walk_stand_in(calls):
    def launch(tags, age, tag_s, acc_s, per_set, first, hit_s):
        calls.append("set_walk")
        _emulate_set_walk(tags.numpy(), age.numpy(), tag_s.numpy(),
                          acc_s.numpy(), per_set.numpy(), first.numpy(),
                          hit_s.numpy())
    return launch


def _lane_scan_stand_in(calls):
    def launch(table, rounds, geo, tags, ts, hits, miss, *, r_pad, suffix):
        calls.append("lane_scan")
        _emulate_lane_scan(table.numpy(), rounds.numpy(), geo.numpy(),
                           tags.numpy(), ts.numpy(), hits.numpy(),
                           None if miss is None else miss.numpy(), r_pad,
                           suffix)
    return launch


def _no_plain(*a, **k):
    raise AssertionError("a CUDA tensor took the plain loop")


# --------------------------------------------------------------------------
# drawn inputs
# --------------------------------------------------------------------------
@st.composite
def _arrivals(draw):
    """Set-sorted arrivals of one geometry and a warm (or cold) state:
    ways 1-8 and past the kernels' register bound (16, 40, 128), tags
    from a small range so that sets hit, ages and access counts over all
    of int32 so that sums wrap."""
    sets = draw(st.sampled_from([1, 2, 4, 8]))
    ways = draw(st.one_of(st.integers(1, 8), st.sampled_from([16, 40, 128])))
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
    ways 1-8, 16 and 40 (one set included), blocks of 32/64/128 bytes, a shared or
    per-lane stream with padding segments, cold flags, masks including
    0 and the full mask, and every suffix mode."""
    n_lane = draw(st.integers(1, 3))
    geos = [(draw(st.sampled_from([1, 2, 4, 8])),
             draw(st.one_of(st.integers(1, 8), st.sampled_from([16, 40]))),
             draw(st.sampled_from([32, 64, 128]))) for _ in range(n_lane)]
    sets, ways, bbs = (np.asarray(v, np.int64) for v in zip(*geos))
    n_seg = draw(st.integers(1, 8))
    rows = n_lane if draw(st.booleans()) else 1
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    stride_max = int(bbs.min())
    bases = rng.integers(0, 64, (rows, n_seg)) * 16
    strides = rng.choice([s for s in (4, 8, 16, 32) if s <= stride_max],
                         (rows, n_seg))
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


def _emulated_lane_scan(table, rounds, geo, max_sets, max_ways, r_pad,
                        suffix):
    n_lane, n_seg, _ = table.shape
    tags = np.full((n_lane, max_ways, max_sets), -1, np.int32)
    ts = np.zeros_like(tags)
    hits = np.zeros((n_lane, n_seg), np.int64)
    miss = np.zeros((n_lane, n_seg, r_pad, max_sets), bool)
    _emulate_lane_scan(table, rounds, geo, tags, ts, hits, miss, r_pad,
                       suffix)
    return hits, miss, tags, ts


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
    np.testing.assert_array_equal(got[0], want[0].numpy())
    if collect:
        np.testing.assert_array_equal(got[1], want[1].numpy())
    else:
        assert want[1] is None
    np.testing.assert_array_equal(got[2], want[2].numpy())
    np.testing.assert_array_equal(got[3], want[3].numpy())


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
    with pytest.raises(ValueError, match="CUDA"):
        K.lane_scan_kernel(torch.zeros((1, 1, len(K.FIELDS)),
                                       dtype=torch.int64),
                           torch.zeros(1, dtype=torch.int32),
                           torch.ones((1, 3), dtype=torch.int64),
                           z32[None], z32[None].clone(),
                           torch.zeros((1, 1), dtype=torch.int64), None,
                           r_pad=1, suffix="full")


def test_chip_smoke_llc_cases_cover_every_suffix_and_mask():
    """``chip_smoke.py``'s kernel checks draw their cases from
    ``llc_cases``: every suffix mode, masked and unmasked lanes, one
    set, lanes wider than one block of threads (``THREADS`` in
    ``csrc/llc.cu``) and a warm set walk."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    walks, lanes = chip_smoke.llc_cases(torch.device("cpu"))
    assert {c["suffix"] for c in lanes} == {"full", "one", "none"}
    assert any(c["masked"] for c in lanes)
    assert any(not c["masked"] for c in lanes)
    assert any(c["max_sets"] == 1 for c in lanes)
    assert any(c["max_sets"] > 128 for c in lanes)
    assert any(w["warm"] for w in walks)
    for c in lanes:
        want = ref.lane_scan_ref(c["table"], c["rounds"], c["geo"],
                                 **c["kw"])
        assert want[0].shape == c["table"].shape[:2]


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
def test_engines_on_card_are_the_cpu_engines():
    """``core.cache``'s two engines on the card give the CPU route's
    results bit for bit (hits, miss runs, miss bits, state)."""
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

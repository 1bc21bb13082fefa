"""The NoC switch kernel (``csrc/noc.cu``) and its plain version.

``_emulate_switch`` is a numpy copy of the kernel's warp walk and is the
spec to keep in step with ``csrc/noc.cu``: the schedule staged
``STAGE_CYCLES`` rows at a time, a lane a port holding its FIFO's head
in registers, the eligible heads grouped by destination (the
``__match_any_sync`` mask), each group's first member in rotation from
its egress's pointer (a shift and ``__ffs``), the granted egresses
gathered by one OR, the bundle loop's early exit and its count of
bundles started; past 32 ports the block route (``_emulate_switch_block``:
the port table, each eligible head's rotation key posted to its egress
by ``atomicMin`` in any order, the least key the winner).  On the CPU
it is held bit for bit to the per-cycle scheduler
(``core.noc.simulate_reference``), the plain version
(``kernels/noc/ref.py``, the token-bundle loop the port ran before)
and the JAX package's ``NoCSwitch`` over hypothesis-drawn schedules
(1–8, 32, 33, 64 and 100 ports, links 0–6, bundles 1, 3, 7 and 64,
unbounded and overflowing FIFOs), explicit edges and the SoC farm's
schedules (up to 62 nodes), and it stands in for the kernel to show
that ``NoCSwitch.simulate`` on a CUDA tensor takes one launch and never
the plain loop.  The ``gpu`` cases
hold the built kernel to the plain version on the card, bit for bit.
The reference is imported inside the tests that use it, so the module
stays JAX-free for the card.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import noc  # noqa: E402
from repro_torch.core.farm import FarmConfig, farm_schedule  # noqa: E402
from repro_torch.kernels.noc import kernel as K  # noqa: E402
from repro_torch.kernels.noc import ops, ref  # noqa: E402

STAGE_CYCLES = 64    # noc.cu: schedule rows staged at once
FIELDS = ("deliver_cycle", "egress", "src", "latency")


# --------------------------------------------------------------------------
# the spec: noc.cu's warp walk in numpy
# --------------------------------------------------------------------------
def _ffs(x: int) -> int:
    """``__ffs``: one plus the index of the lowest set bit, 0 for none."""
    return (x & -x).bit_length()


def _emulate_switch_block(dests, status, granted, src, lat, *, link, depth,
                          total, bundle, n_chunks):
    """``noc_switch_wide_kernel`` (more than ``K.WARP_PORTS`` ports): one
    block walks the switch from its port table, the schedule staged
    ``K.stage_rows(ports)`` rows at a time; a cycle's three phases
    between barriers: each ingress injects and, with an eligible head,
    posts its rotation key (p - pointer[e]) mod ports to its egress e by
    ``atomicMin`` (the least key wins, in whatever order the posts
    land); each egress turns its least key into its winner, writes its
    row, moves its pointer and clears the key; each ingress its egress
    named pops.  The delivered count is folded at bundle boundaries."""
    t_rows, ports = dests.shape
    h_pad = granted.shape[0]
    rows = K.stage_rows(ports)
    flat = dests.reshape(-1)
    ring = np.zeros((ports, depth, 2), np.int64)
    head, size, h_ts, h_dst, rr = (np.zeros(ports, np.int64)
                                   for _ in range(5))
    bid = np.full(ports, ports, np.int64)
    delivered = overflow = bundles = granted_here = 0
    staged, stage = -rows, None
    p_idx = np.arange(ports)
    for b in range(n_chunks):
        delivered, granted_here = delivered + granted_here, 0
        if delivered >= total:
            break
        c0 = b * bundle
        if c0 >= h_pad:
            bundles = n_chunks
            break
        bundles += 1
        for c in range(c0, min(c0 + bundle, h_pad)):
            if c >= staged + rows:
                staged = c
                g = c * ports + np.arange(rows * ports)
                stage = np.full(g.shape, -1, np.int64)
                stage[g < flat.size] = flat[g[g < flat.size]]
            # inject, then post each eligible head's key (the posts'
            # order is shuffled: the least key is the same in any order)
            d = stage[(c - staged) * ports + p_idx]
            for p in np.random.default_rng(c).permutation(ports).tolist():
                if d[p] >= 0:
                    if size[p] < depth:
                        pos = head[p] + size[p]
                        pos -= depth if pos >= depth else 0
                        ring[p, pos] = (c, d[p])
                        if size[p] == 0:
                            h_ts[p], h_dst[p] = c, d[p]
                        size[p] += 1
                    else:
                        overflow = 1
                if size[p] > 0 and c - h_ts[p] >= link:
                    e = h_dst[p]
                    key = p - rr[e]
                    key += ports if key < 0 else 0
                    bid[e] = min(bid[e], key)
            # grant
            won = bid < ports
            winner = np.where(won, bid + rr, -1)
            winner = np.where(winner >= ports, winner - ports, winner)
            granted[c] = won
            src[c] = winner
            lat[c] = np.where(won, c - h_ts[np.maximum(winner, 0)], 0)
            rr = np.where(won, np.where(winner + 1 == ports, 0, winner + 1),
                          rr)
            bid[:] = ports
            granted_here += int(won.sum())
            # deliver
            pop = (size > 0) & (c - h_ts >= link) & (winner[h_dst] == p_idx)
            size -= pop
            head = np.where(pop, np.where(head + 1 == depth, 0, head + 1),
                            head)
            reload = pop & (size > 0)
            h_ts[reload] = ring[p_idx[reload], head[reload], 0]
            h_dst[reload] = ring[p_idx[reload], head[reload], 1]
    status[:] = (delivered + granted_here, int(overflow), bundles)


def _emulate_switch(dests, status, granted, src, lat, *, link, depth, total,
                    bundle, n_chunks):
    """``noc_switch_kernel``: one warp walks the switch, lane p owning
    ingress FIFO p and egress p's pointer; dests (T, ports) int32;
    status (3,), granted / src / lat (h_pad, ports) written as the
    kernel writes them (zero on entry).  More than ``K.WARP_PORTS``
    ports take the block route (``_emulate_switch_block``)."""
    t_rows, ports = dests.shape
    if ports > K.WARP_PORTS:
        return _emulate_switch_block(dests, status, granted, src, lat,
                                     link=link, depth=depth, total=total,
                                     bundle=bundle, n_chunks=n_chunks)
    h_pad = granted.shape[0]
    lanes = np.arange(ports)
    flat = dests.reshape(-1)
    ring = np.zeros((ports, depth, 2), np.int64)
    head, size, rr = (np.zeros(ports, np.int64) for _ in range(3))
    h_ts, h_dst = np.zeros(ports, np.int64), np.zeros(ports, np.int64)
    delivered = overflow = bundles = 0
    staged, stage = -STAGE_CYCLES, None
    for b in range(n_chunks):
        if delivered >= total:
            break
        c0 = b * bundle
        if c0 >= h_pad:
            bundles = n_chunks
            break
        bundles += 1
        for c in range(c0, min(c0 + bundle, h_pad)):
            if c >= staged + STAGE_CYCLES:
                staged = c
                g = c * ports + np.arange(STAGE_CYCLES * ports)
                stage = np.full(g.shape, -1, np.int64)
                stage[g < flat.size] = flat[g[g < flat.size]]
            # inject
            d = stage[(c - staged) * ports + lanes]
            push = d >= 0
            ok = push & (size < depth)
            overflow |= bool((push & ~ok).any())
            pos = head + size
            pos = np.where(pos >= depth, pos - depth, pos)
            ring[lanes[ok], pos[ok]] = np.stack([np.full(ok.sum(), c),
                                                 d[ok]], -1)
            fresh = ok & (size == 0)
            h_ts[fresh], h_dst[fresh] = c, d[fresh]
            size += ok
            # arbitrate: __match_any_sync over the eligible heads'
            # destinations (ineligible lanes key on 32 + lane), the
            # egress's pointer by __shfl_sync, the rotation by __ffs
            elig = (size > 0) & (c - h_ts >= link)
            key = np.where(elig, h_dst, 32 + lanes)
            group = [sum(1 << int(q) for q in lanes[key == key[p]])
                     for p in lanes]
            r = rr[np.where(elig, h_dst, lanes)]
            win = np.zeros(ports, bool)
            for p in lanes[elig]:
                from_r = group[p] >> int(r[p])
                sel = int(r[p]) + _ffs(from_r) - 1 if from_r \
                    else _ffs(group[p]) - 1
                win[p] = sel == p
            grants = 0
            win_src, win_lat = np.zeros(32, np.int64), np.zeros(32, np.int64)
            for p in lanes[win]:
                win_src[h_dst[p]], win_lat[h_dst[p]] = p, c - h_ts[p]
                grants |= 1 << int(h_dst[p])
            # deliver
            g = (grants >> lanes) & 1 == 1
            s = np.where(g, win_src[:ports], -1)
            granted[c] = g
            src[c] = s
            lat[c] = np.where(g, win_lat[:ports], 0)
            rr = np.where(g, np.where(s + 1 == ports, 0, s + 1), rr)
            delivered += bin(grants).count("1")
            size -= win
            head = np.where(win, np.where(head + 1 == depth, 0, head + 1),
                            head)
            reload = win & (size > 0)
            h_ts[reload] = ring[lanes[reload], head[reload], 0]
            h_dst[reload] = ring[lanes[reload], head[reload], 1]
    status[:] = (delivered, int(overflow), bundles)


def _emulated_run(dests, *, link, depth, total, h_pad, bundle) -> ops.SwitchRun:
    """What ``ops.switch`` returns on the card, by the emulation."""
    ports = dests.shape[1]
    status = np.zeros(3, np.int64)
    granted = np.zeros((h_pad, ports), bool)
    src = np.zeros((h_pad, ports), np.int32)
    lat = np.zeros((h_pad, ports), np.int32)
    _emulate_switch(np.asarray(dests, np.int32), status, granted, src, lat,
                    link=link, depth=depth, total=total, bundle=bundle,
                    n_chunks=ops.n_bundles(h_pad, bundle))
    return ops.SwitchRun(torch.from_numpy(granted), torch.from_numpy(src),
                         torch.from_numpy(lat), int(status[0]),
                         bool(status[1]), int(status[2]))


def _switch_stand_in(calls):
    """Stands in for ``kernel.switch_kernel``: notes the FIFO scratch's
    shape (None: the rings in shared memory) and, where the block route
    takes one, the port table scratch's."""
    def launch(dests, status, granted, src, lat, fifo, table, *, link, depth,
               total, bundle, n_chunks):
        if (table is None) != K.table_in_shared(dests.shape[1]) or (
                fifo is None) != K.fifo_in_shared(dests.shape[1], depth):
            raise AssertionError("the scratches do not match the shared "
                                 "memory rules")
        calls.append((None if fifo is None else tuple(fifo.shape))
                     if table is None else (tuple(fifo.shape),
                                            tuple(table.shape)))
        _emulate_switch(dests.numpy(), status.numpy(), granted.numpy(),
                        src.numpy(), lat.numpy(), link=link, depth=depth,
                        total=total, bundle=bundle, n_chunks=n_chunks)
    return launch


def _no_plain(*a, **k):
    raise AssertionError("a CUDA tensor took the plain loop")


def _params(dests, ports, link, depth):
    """The config and the switch op's operands for a schedule, as
    ``NoCSwitch`` makes them."""
    cfg = noc.NoCConfig(ports=ports, link_latency=link, queue_depth=depth)
    return (cfg, *noc.switch_args(dests, cfg))


def _assert_runs_equal(got: ops.SwitchRun, want: ops.SwitchRun, ctx: str):
    for f in ("granted", "src", "lat"):
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype and torch.equal(a.cpu(), w.cpu()), \
            f"{ctx}: {f} differs"
    assert (got.delivered, got.overflow, got.bundles) == \
        (want.delivered, want.overflow, want.bundles), ctx


def _log(run: ops.SwitchRun, h_pad: int, bundle: int) -> noc.NoCResult:
    """A run's delivery log, as ``NoCSwitch.simulate`` makes it."""
    cyc, egr = np.nonzero(run.granted.cpu().numpy())
    return noc.NoCResult(
        deliver_cycle=cyc, egress=egr,
        src=run.src.cpu().numpy()[cyc, egr].astype(np.int64),
        latency=run.lat.cpu().numpy()[cyc, egr].astype(np.int64),
        cycles_run=min(run.bundles * bundle, h_pad), host_steps=run.bundles)


def _hold_to_all(dests, ports, link, depth, bundle, *, jax_too=True):
    """The emulation against the plain version, the per-cycle scheduler
    and (``jax_too``) the reference's ``NoCSwitch``: every array, the
    delivered count, the overflow flag and the bundles run."""
    cfg, d32, kw = _params(dests, ports, link, depth)
    got = _emulated_run(d32.numpy(), bundle=bundle, **kw)
    ctx = f"ports={ports} link={link} depth={depth} bundle={bundle}"
    _assert_runs_equal(got, ref.switch_ref(d32, bundle=bundle, **kw), ctx)
    log = _log(got, kw["h_pad"], bundle)
    want, jax_want = None, None
    try:
        want = noc.simulate_reference(dests, cfg)
    except noc.NoCOverflowError:
        assert got.overflow and got.bundles == ops.n_bundles(kw["h_pad"],
                                                             bundle), ctx
    if jax_too:
        from repro.core import noc as j_noc

        try:
            jax_want = j_noc.NoCSwitch(j_noc.NoCConfig(
                ports=ports, link_latency=link, queue_depth=depth)).simulate(
                dests, bundle_cycles=bundle)
        except j_noc.NoCOverflowError:
            assert want is None, ctx
    if want is None:
        return got
    assert not got.overflow and got.delivered == kw["total"], ctx
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(log, f), getattr(want, f),
                                      err_msg=f"{ctx}: {f}")
        if jax_want is not None:
            np.testing.assert_array_equal(getattr(log, f),
                                          getattr(jax_want, f),
                                          err_msg=f"{ctx}: {f} (reference)")
    if jax_want is not None:
        assert (log.host_steps, log.cycles_run) == \
            (jax_want.host_steps, jax_want.cycles_run), ctx
    return got


@st.composite
def _schedules(draw):
    """(dests, ports, link, depth, bundle): a random schedule with ~p
    of cycles injecting a port, an unbounded FIFO or a small finite one
    (which may overflow)."""
    ports = draw(st.sampled_from([1, 2, 3, 4, 5, 6, 7, 8, 32]))
    cycles = draw(st.integers(0, 40 if ports < 32 else 12))
    link = draw(st.integers(0, 6))
    bundle = draw(st.sampled_from([1, 3, 7, 64]))
    depth = draw(st.sampled_from([None, None, 1, 2, 4]))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    p_inject = draw(st.sampled_from([0.1, 0.4, 0.8]))
    dests = np.where(rng.random((cycles, ports)) < p_inject,
                     rng.integers(0, ports, (cycles, ports)), -1)
    # some "no flit" entries below -1: any negative entry injects nothing
    dests[rng.random(dests.shape) < 0.05] = -7
    return dests.astype(np.int64), ports, link, depth, bundle


@st.composite
def _wide_schedules(draw):
    """``_schedules`` past ``K.WARP_PORTS``: 33, 64 or 100 ports (the
    block route), over fewer cycles."""
    ports = draw(st.sampled_from([33, 64, 100]))
    cycles = draw(st.integers(0, 12))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    p_inject = draw(st.sampled_from([0.1, 0.4, 0.8]))
    dests = np.where(rng.random((cycles, ports)) < p_inject,
                     rng.integers(0, ports, (cycles, ports)), -1)
    if draw(st.booleans()):   # hot egresses: long queues and rotation
        dests = np.where(dests >= 0, dests % 3, dests)
    return (dests.astype(np.int64), ports, draw(st.integers(0, 6)),
            draw(st.sampled_from([None, None, 1, 2, 4])),
            draw(st.sampled_from([1, 3, 7, 64])))


# --------------------------------------------------------------------------
# the emulation against the scheduler, the plain version, the reference
# --------------------------------------------------------------------------
@settings(max_examples=40, deadline=None, database=None)
@given(case=_schedules())
def test_emulation_is_the_scheduler_the_plain_version_and_the_reference(case):
    _hold_to_all(*case)


@settings(max_examples=12, deadline=None, database=None)
@given(case=_wide_schedules())
def test_block_route_emulation_is_the_scheduler_the_plain_version_and_the_reference(  # noqa: E501
        case):
    """The block route (33, 64 and 100 ports): the posted least rotation
    keys, in any order, against the per-cycle scheduler, the plain
    version and the JAX package's ``NoCSwitch``."""
    _hold_to_all(*case)


EDGES = {
    # (dests, ports, link, depth, bundle)
    "empty schedule": (np.full((0, 3), -1), 3, 2, None, 64),
    "no flit at all": (np.full((9, 2), -1), 2, 1, None, 7),
    "overflow": (np.full((8, 2), 1), 2, 0, 1, 7),
    "overflow, one bundle a cycle": (np.full((5, 3), 2), 3, 1, 2, 1),
    "bundle 7 over 47 cycles": (np.tile([[1, 0, 0, 2]], (20, 1)), 4, 3,
                                None, 7),
    "link 0": (np.tile([[1, 0], [0, -1]], (10, 1)), 2, 0, None, 3),
    "one port": (np.tile([[0], [-1], [0]], (7, 1)), 1, 2, None, 7),
    "32 ports onto one egress": (np.full((3, 32), 31), 32, 1, None, 64),
    "32 ports round robin": (np.tile(np.arange(32)[::-1], (4, 1)), 32, 0,
                             None, 7),
    "link longer than the schedule": (np.full((2, 2), 1), 2, 40, None, 3),
    "33 ports onto one egress": (np.full((3, 33), 32), 33, 1, None, 64),
    "64 ports round robin": (np.tile(np.arange(64)[::-1], (4, 1)), 64, 0,
                             None, 7),
    "100 ports, overflow": (np.full((6, 100), 7), 100, 0, 2, 3),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_emulation_edges(name):
    got = _hold_to_all(*EDGES[name])
    if name == "empty schedule":
        assert (got.bundles, got.delivered) == (0, 0)
        assert not got.granted.any()


@pytest.mark.parametrize("nodes", [0, 1, 2, 3, 4, 30, 31, 62])
@pytest.mark.parametrize("bundle", [7, 64])
def test_emulation_on_the_farm_schedules(nodes, bundle):
    farm = FarmConfig(nodes=nodes)
    _hold_to_all(farm_schedule(24, farm), nodes + 2, farm.link_latency, None,
                 bundle, jax_too=bundle == 64)


# --------------------------------------------------------------------------
# the CUDA route, the emulation standing in for the launch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ports, depth", [(6, None), (32, 900)])
def test_cuda_route_is_one_launch_through_noc_switch(monkeypatch, ports,
                                                     depth):
    """With the op seeing a CUDA device, ``NoCSwitch.simulate`` makes one
    launch (the rings in shared memory, or a global scratch where they
    do not fit) and never the plain loop, and its log is the per-cycle
    scheduler's with the plain version's host steps."""
    rng = np.random.default_rng(ports)
    dests = np.where(rng.random((60, ports)) < 0.3,
                     rng.integers(0, ports, (60, ports)), -1)
    # "no flit" entries far below int32: the route normalises them to -1
    dests[rng.random(dests.shape) < 0.05] = -(2**33)
    cfg = noc.NoCConfig(ports=ports, link_latency=2, queue_depth=depth)
    want = noc.NoCSwitch(cfg, device="cpu").simulate(dests, bundle_cycles=7)
    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    got = noc.NoCSwitch(cfg, device="cpu").simulate(dests, bundle_cycles=7)
    fits = K.fifo_in_shared(ports, depth or 1)
    assert calls == [None if fits else (ports, depth, 2)]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.host_steps, got.cycles_run) == (want.host_steps,
                                                want.cycles_run)


def test_cuda_route_raises_on_overflow_after_one_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    with pytest.raises(noc.NoCOverflowError):
        noc.NoCSwitch(noc.NoCConfig(ports=2, link_latency=0, queue_depth=1),
                      device="cpu").simulate(np.full((8, 2), 1))
    assert calls == [None]


def _sparse_reference(dests, cfg):
    """``core.noc.simulate_reference`` with each egress's rotation scan
    taken over the heads aimed at it only (the first in rotation from
    its pointer is the least (p - pointer) mod ports among them): the
    same scheduler, O(flits) a cycle instead of O(ports**2), for switches
    too wide for the plain-Python loop (held to it below)."""
    dests = np.asarray(dests, np.int64)
    total, horizon, depth = noc._schedule_params(dests, cfg)
    ports, link = cfg.ports, cfg.link_latency
    queues = [[] for _ in range(ports)]
    rr, rows, delivered, c = [0] * ports, [], 0, 0
    while delivered < total and c < horizon:
        if c < dests.shape[0]:
            for p in np.flatnonzero(dests[c] >= 0).tolist():
                if len(queues[p]) >= depth:
                    raise noc.NoCOverflowError(f"FIFO {p} at cycle {c}")
                queues[p].append((c, int(dests[c, p])))
        heads = {}
        for p, q in enumerate(queues):
            if q and q[0][0] + link <= c:
                heads.setdefault(q[0][1], []).append(p)
        for e in sorted(heads):
            p = min(heads[e], key=lambda p: (p - rr[e]) % ports)
            rows.append((c, e, p, c - queues[p].pop(0)[0]))
            rr[e] = (p + 1) % ports
            delivered += 1
        c += 1
    arr = np.asarray(rows, np.int64).reshape(-1, 4)
    return noc.NoCResult(deliver_cycle=arr[:, 0], egress=arr[:, 1],
                         src=arr[:, 2], latency=arr[:, 3], cycles_run=c)


@pytest.mark.parametrize("ports", [33, 100])
def test_sparse_reference_is_the_scheduler(ports):
    rng = np.random.default_rng(ports)
    dests = np.where(rng.random((30, ports)) < 0.4,
                     rng.integers(0, ports, (30, ports)), -1)
    cfg = noc.NoCConfig(ports=ports, link_latency=1)
    want, got = noc.simulate_reference(dests, cfg), _sparse_reference(dests,
                                                                      cfg)
    for f in FIELDS + ("cycles_run",):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("ports, depth", [(33, None), (64, 512), (100, 3),
                                         (7000, None)])
def test_cuda_route_runs_wide_switches_in_one_launch(monkeypatch, ports,
                                                     depth):
    """Past 32 ports ``NoCSwitch.simulate`` on a CUDA tensor is one
    launch of the block route (stood in for by its emulation), its port
    table and rings in shared memory, in global scratches where they do
    not fit (64 ports at depth 512: 256 KiB of rings; 7,000 ports: the
    table too), never the plain loop; its log is the per-cycle
    scheduler's, or it overflows where the scheduler does."""
    rng = np.random.default_rng(ports)
    cycles = 40 if ports < 1000 else 4
    dests = np.where(rng.random((cycles, ports)) < 0.3,
                     rng.integers(0, ports, (cycles, ports)), -1)
    dests[:, 1] = ports - 1   # one egress oversubscribed
    cfg = noc.NoCConfig(ports=ports, link_latency=2, queue_depth=depth)
    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    try:
        want = (noc.simulate_reference if ports < 1000 else
                _sparse_reference)(dests, cfg)
    except noc.NoCOverflowError:
        with pytest.raises(noc.NoCOverflowError):
            noc.NoCSwitch(cfg, device="cpu").simulate(dests, bundle_cycles=7)
        assert len(calls) == 1
        return
    got = noc.NoCSwitch(cfg, device="cpu").simulate(dests, bundle_cycles=7)
    d = depth or int((dests >= 0).sum(axis=0).max())
    rings = None if K.fifo_in_shared(ports, d) else (ports, d, 2)
    assert calls == [rings if K.table_in_shared(ports)
                     else (rings, (K.table_bytes(ports) // 4,))]
    assert (ports, depth) != (64, 512) or rings is not None
    assert ports != 7000 or not K.table_in_shared(ports)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_wide_switch_raises_past_the_cards_memory(monkeypatch):
    """What is left of the port limit on the card is its memory: the op
    holds the log, rings and port table to the free bytes before any
    allocation or launch, and names them."""
    from repro_torch.utils import env

    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    monkeypatch.setattr(env, "free_device_bytes", lambda dev: 10_000)
    monkeypatch.setattr(ops, "check_device_memory", lambda dev, n, what:
                        env.check_device_memory(torch.device("cuda"), n,
                                                what))
    with pytest.raises(MemoryError, match="switch's log"):
        noc.NoCSwitch(noc.NoCConfig(ports=64), device="cpu").simulate(
            np.full((40, 64), 3))
    assert calls == []


def test_switch_raises_past_int32_indexing(monkeypatch):
    """The other limit: cycles and ports index in int32, and the op
    raises on the card route before any allocation or launch."""
    calls = []
    monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    with pytest.raises(ValueError, match="int32"):
        ops.switch(torch.full((2, 40), -1, dtype=torch.int32), link=0,
                   depth=1, total=0, h_pad=2**31, bundle=1)
    assert calls == []


def test_block_route_tables_fit_their_memory():
    """The block route's port table (kPortFields arrays and the staged
    rows, fewer for wide switches) and where each part lives."""
    assert [K.stage_rows(p) for p in (33, 64, 100, 1000, 5000)] == [
        64, 64, 40, 4, 1]
    assert K.table_bytes(64) == 4 * 64 * (K.PORT_FIELDS + 64)
    assert K.threads(33) == 64 and K.threads(1000) == 1024 \
        and K.threads(5000) == 1024
    assert K.fifo_in_shared(64, 256) and not K.fifo_in_shared(64, 512)
    assert K.table_in_shared(6000) and not K.table_in_shared(7000)
    assert not K.fifo_in_shared(7000, 1)


@pytest.mark.parametrize("route", ["cpu", "cuda"])
@pytest.mark.parametrize("dest", [4, 31, 32, 40])
def test_switch_op_refuses_destinations_past_its_ports(monkeypatch, route,
                                                       dest):
    """A destination >= ports names no egress: the op raises on either
    route, before the plain loop or a launch (on the card it would be
    granted on a missing egress, or index past the lanes' windows)."""
    calls = []
    if route == "cuda":
        monkeypatch.setattr(ops, "_device_type", lambda x: "cuda")
    monkeypatch.setattr(ref, "switch_ref", _no_plain)
    monkeypatch.setattr(K, "switch_kernel", _switch_stand_in(calls))
    _, d32, kw = _params(np.full((6, 4), 1), 4, 1, None)
    d32[3, 2] = dest
    with pytest.raises(ValueError, match="< ports"):
        ops.switch(d32, bundle=7, **kw)
    assert calls == []


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launch wrapper takes CUDA tensors only: nothing there falls
    back to the plain version."""
    z = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.switch_kernel(z, torch.zeros(3, dtype=torch.int32),
                        torch.zeros((4, 2), dtype=torch.bool), z.clone(),
                        z.clone(), None, None, link=0, depth=1, total=0,
                        bundle=1, n_chunks=4)


def test_bundle_count_is_chunked_scans():
    """``ops.n_bundles`` is the bundle count ``chunked_scan`` pads to."""
    from repro_torch.core.fame1 import chunked_scan

    for h_pad in (1, 2, 64, 4096):
        for bundle in (1, 3, 7, 64, 5000):
            _, _, ran = chunked_scan(
                lambda c, x, a: (c, x), torch.tensor(0),
                torch.zeros(h_pad), cont_fn=lambda c: True, chunk_len=bundle)
            assert ran == ops.n_bundles(h_pad, bundle)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_against_plain(dests, ports, link, depth, bundle, dev):
    _, d32, kw = _params(dests, ports, link, depth)
    before = K.launches
    got = ops.switch(d32.to(dev), bundle=bundle, **kw)
    assert K.launches == before + 1
    _assert_runs_equal(got, ref.switch_ref(d32, bundle=bundle, **kw),
                       f"ports={ports} link={link} depth={depth} "
                       f"bundle={bundle}")


@pytest.mark.gpu
@settings(max_examples=40, deadline=None, database=None)
@given(case=_schedules())
def test_switch_kernel_is_the_plain_version_on_card(case):
    _kernel_against_plain(*case, _card())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EDGES))
def test_switch_kernel_edges_on_card(name):
    _kernel_against_plain(*EDGES[name], _card())


@pytest.mark.gpu
@pytest.mark.parametrize("nodes", [0, 4])
@pytest.mark.parametrize("bundle", [1, 7, 64])
def test_switch_kernel_on_the_farm_schedules_on_card(nodes, bundle):
    farm = FarmConfig(nodes=nodes)
    _kernel_against_plain(farm_schedule(128, farm), nodes + 2,
                          farm.link_latency, None, bundle, _card())


@pytest.mark.gpu
@settings(max_examples=30, deadline=None, database=None)
@given(case=_wide_schedules())
def test_block_route_kernel_is_the_plain_version_on_card(case):
    _kernel_against_plain(*case, _card())


@pytest.mark.gpu
@pytest.mark.parametrize("nodes", [30, 31, 62])
@pytest.mark.parametrize("bundle", [1, 7, 64])
def test_switch_kernel_on_wide_farm_schedules_on_card(nodes, bundle):
    """The farm at 32 ports (the one-warp route's edge), 33 and 64 (the
    block route, its rings in global memory at 64)."""
    farm = FarmConfig(nodes=nodes)
    _kernel_against_plain(farm_schedule(128, farm), nodes + 2,
                          farm.link_latency, None, bundle, _card())


@pytest.mark.gpu
@pytest.mark.parametrize("ports, depth", [(64, 512), (1000, 4),
                                         (7000, None)])
def test_block_route_with_global_scratches_on_card(ports, depth):
    """Rings past shared memory (64 x 512), a thread a port at 1,000
    ports (its FIFOs overflowing), and the port table in global memory
    too at 7,000 ports."""
    rng = np.random.default_rng(ports)
    dests = np.where(rng.random((12, ports)) < 0.2,
                     rng.integers(0, ports, (12, ports)), -1)
    dests[:, :3] = 5
    assert ports != 7000 or not K.table_in_shared(ports)
    _kernel_against_plain(dests, ports, 1, depth, 7, _card())


@pytest.mark.gpu
def test_switch_kernel_with_global_rings_on_card():
    """Rings too deep for shared memory live in the global scratch."""
    rng = np.random.default_rng(3)
    dests = np.where(rng.random((80, 32)) < 0.5,
                     rng.integers(0, 32, (80, 32)), -1)
    assert not K.fifo_in_shared(32, 900)
    _kernel_against_plain(dests, 32, 1, 900, 7, _card())

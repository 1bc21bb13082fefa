"""Plain PyTorch versions of the LLC replay engines: the round loops
``core/cache.py`` ran from the host, one eager op at a time, on the
operands' own device.  The kernels (``kernel.py``) compute the same
outputs bit for bit; ``tests/test_torch_llc.py`` holds a numpy emulation
of the kernels' per-thread walk to these."""
from __future__ import annotations

import torch

from repro_torch.kernels.llc.kernel import FIELDS
from repro_torch.utils.address import fdiv, first_access, last_access

_IMAX = torch.iinfo(torch.int32).max


def set_walk_ref(tags, age, tag_s, acc_s, per_set, first):
    """One geometry's per-set round walk.  tags/age (sets, ways) int32;
    tag_s/acc_s (n,) int32, the arrivals in set-sorted order; per_set /
    first (sets,) int64.  Round r retires arrival first[s] + r of every
    set s that has one: a matching tag wins, else the first way of
    greatest age; the touched way's age resets to 0 and every other way
    ages by the arrival's access count.  Returns (hits (n,) bool, tags,
    age), new tensors."""
    n_total = tag_s.shape[0]
    hit_s = torch.zeros(n_total + 1, dtype=torch.bool, device=tag_s.device)
    rounds = int(per_set.max()) if n_total else 0
    for r in range(rounds):
        pos = first + r
        v = per_set > r
        pick = torch.clamp(pos, max=n_total - 1)
        t, a = tag_s[pick], acc_s[pick]
        match = tags == t[:, None]
        hit = match.any(dim=1)
        score = torch.where(match, _IMAX, age)
        is_max = score == score.amax(dim=1, keepdim=True)
        touched = (is_max.cumsum(dim=1) == 1) & is_max & v[:, None]
        tags = torch.where(touched, t[:, None], tags)
        age = torch.where(v[:, None],
                          torch.where(touched, 0, age + a[:, None]), age)
        hit_s[torch.where(v, pos, n_total)] = hit & v
    return hit_s[:n_total], tags, age


def lane_scan_ref(table, rounds, geo, *, max_sets: int, max_ways: int,
                  r_pad: int, collect: bool, suffix: str):
    """L geometries' segment replay (``core.cache.segment_lane_scan``'s
    device part).  table (L, S, len(FIELDS)) int64, each lane's segment
    plan; rounds (S,) int32; geo (L, 3) int64 (sets, ways, block bytes).
    Per segment: ``rounds[j]`` rounds of the per-set walk over the
    segment's first ``n_pre`` blocks (a matching tag wins, else the
    oldest way the segment's ``wsel`` lets it allocate into, a zero
    ``wsel`` meaning every real way), then the closed-form suffix
    (``"full"``: the oldest-first rank insert; ``"one"``: one oldest-way
    eviction; ``"none"``: nothing).  Returns (round hits (L, S) int64,
    miss bits (L, S, r_pad, max_sets) bool or None, tags, ts), the state
    (L, max_ways, max_sets) int32."""
    dev = table.device
    n_lane, n_seg = table.shape[:2]

    def per_segment(name):
        """(L, S) field -> (S, L, 1): row j is segment j's per-lane
        column, a view."""
        return table[:, :, FIELDS.index(name)].T[:, :, None]

    base_d, stride_d, count_d, b_first_d, n_pre_d, sb_first_d, n_suf_d, \
        counter_d = (per_segment(f) for f in FIELDS[:-1])
    live = (table[:, :, FIELDS.index("count")] > 0).any(dim=0).tolist()
    has_suf = ((table[:, :, FIELDS.index("n_suf")] > 0).any(dim=0)
               & (suffix != "none")).tolist()
    rounds = rounds.tolist()

    s_idx = torch.arange(max_sets, device=dev)
    q_idx = torch.arange(max_ways, device=dev)
    sets_d = geo[:, 0:1]                                      # (L, 1)
    ways_d = geo[:, 1:2, None]                                # (L, 1, 1)
    bb_d = geo[:, 2:3]
    set_mask = s_idx[None, :] < sets_d                        # (L, MS)
    way_mask = (q_idx[None, :] < ways_d[:, :, 0])[:, :, None]  # (L, MW, 1)
    # per-segment allocation masks: the mask's bits limited to real ways;
    # the zero sentinel allocates anywhere real
    wsel = table[:, :, FIELDS.index("wsel"), None]            # (L, S, 1)
    bits = (wsel >> q_idx) & 1
    alloc = (q_idx < ways_d) & ((wsel == 0) | (bits != 0))    # (L, S, MW)
    alloc_d = alloc.transpose(0, 1)[:, :, :, None]            # (S, L, MW, 1)
    # [a, b]: way b precedes way a in a tie (stable oldest-first rank)
    earlier_way = (q_idx[None, :] < q_idx[:, None])[None, :, :, None]
    tags = torch.full((n_lane, max_ways, max_sets), -1, dtype=torch.int32,
                      device=dev)
    ts = torch.zeros_like(tags)
    miss = (torch.zeros((n_lane, n_seg, r_pad, max_sets),
                        dtype=torch.bool, device=dev) if collect else None)
    round_hits = torch.zeros((n_lane, n_seg), dtype=torch.int64, device=dev)

    for j in range(n_seg):
        if not live[j]:
            continue
        base_j, stride_j, count_j = base_d[j], stride_d[j], count_d[j]
        counter_j = counter_d[j]
        if rounds[j] > 0:
            b_first_j, n_pre_j = b_first_d[j], n_pre_d[j]
            alloc_j = alloc_d[j]
            off = torch.where(set_mask,
                              torch.remainder(s_idx - b_first_j, sets_d), 0)
            hits = torch.zeros(n_lane, dtype=torch.int64, device=dev)
            for k in range(rounds[j]):
                i = off + k * sets_d          # block ordinal within segment
                v = set_mask & (i < n_pre_j)
                blocks = b_first_j + i
                t = fdiv(blocks, sets_d).to(torch.int32)
                j_lo = first_access(blocks, base_j, stride_j, bb_d)
                j_hi = last_access(blocks, base_j, stride_j, count_j, bb_d)
                # the touched way: a matching tag wins outright (key -1,
                # unique per set), else the oldest way it may allocate
                # into; the cumsum first-min mask is argmin's first-index
                # tie-break
                key = torch.where(tags == t[:, None, :], -1,
                                  torch.where(alloc_j, ts, _IMAX))
                kmin = key.amin(dim=1)
                hit = kmin == -1
                is_min = key == kmin[:, None, :]
                first_min = (is_min.cumsum(dim=1) == 1) & is_min
                touched = first_min & v[:, None, :]
                tags = torch.where(touched, t[:, None, :], tags)
                stamp = (counter_j + j_hi + 1).to(torch.int32)
                ts = torch.where(touched, stamp[:, None, :], ts)
                hits = hits + torch.where(v, j_hi - j_lo + hit, 0).sum(dim=1)
                if collect:
                    miss[:, j, k] = v & ~hit
            round_hits[:, j] = hits
        if not has_suf[j]:
            continue
        # closed-form suffix: everything past the round-scanned prefix
        # (the whole segment when cold)
        sb_first_j, n_suf_j = sb_first_d[j], n_suf_d[j]
        off_suf = torch.where(set_mask,
                              torch.remainder(s_idx - sb_first_j, sets_d), 0)
        victim_ts = torch.where(way_mask, ts, _IMAX)
        if suffix == "one":
            # at most one suffix block per set: it evicts the oldest way
            # (min ts, first-index tie-break)
            ins = set_mask & (off_suf < n_suf_j)
            is_old = victim_ts == victim_ts.amin(dim=1, keepdim=True)
            oldest = (is_old.cumsum(dim=1) == 1) & is_old
            blk1 = sb_first_j + off_suf
            t1 = fdiv(blk1, sets_d).to(torch.int32)
            ts1 = (counter_j + last_access(blk1, base_j, stride_j, count_j,
                                            bb_d) + 1).to(torch.int32)
            wr = oldest & ins[:, None, :]
            tags = torch.where(wr, t1[:, None, :], tags)
            ts = torch.where(wr, ts1[:, None, :], ts)
            continue
        m_s = torch.where(off_suf < n_suf_j,
                          fdiv(n_suf_j - off_suf + sets_d - 1, sets_d), 0)
        # each way's rank in oldest-first recency order (stable: ties
        # break on way index)
        vt_a, vt_b = victim_ts[:, :, None, :], victim_ts[:, None, :, :]
        older = (vt_b < vt_a) | ((vt_b == vt_a) & earlier_way)
        rank = older.sum(dim=2)
        m3 = m_s[:, None, :]
        jstar = m3 - torch.remainder(m3 - 1 - rank, ways_d)
        valid_q = way_mask & (jstar >= 1) & set_mask[:, None, :]
        sets3 = sets_d[:, :, None]
        blk = sb_first_j[:, :, None] + off_suf[:, None, :] + (jstar - 1) * sets3
        t_star = fdiv(blk, sets3).to(torch.int32)
        last = last_access(blk, base_j[:, :, None], stride_j[:, :, None],
                            count_j[:, :, None], bb_d[:, :, None])
        ts_star = (counter_j[:, :, None] + last + 1).to(torch.int32)
        tags = torch.where(valid_q, t_star, tags)
        ts = torch.where(valid_q, ts_star, ts)
    return round_hits, miss, tags, ts

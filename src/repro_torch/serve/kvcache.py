"""Paged KV cache: fixed-size token blocks, free-list pool, block tables.

The continuous-batching engine accounts KV capacity the way vLLM does —
a shared pool of fixed-size blocks, a per-request block table — but the
blocks here are *simulated DBB address ranges*, not device memory: the
decode step keeps its shape-static per-slot cache rows, while
the pool decides admission (are there blocks for prompt + max_new?) and
hands the latency oracle the exact byte ranges a request re-reads each
step.  That address map is what makes concurrent requests contend in the
shared LLC: each admitted request adds its live blocks to the per-step
trace, growing the cyclic re-reference distance until the cache stops
covering the working set (the paper's interference story).

Admission is reservation-based: all ``ceil((prompt + max_new) /
block_size)`` blocks are allocated up front, so a request can never be
starved mid-decode by a later admission (no preemption/swap path —
an engine-level future work note in the reference's serving docs).

Invariant (``check_partition``): at any point in any admit/append/
release sequence, the free list and the union of all block tables form a
partition of the pool — every block exactly once, no aliasing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import traces

#: Base byte address of the paged-KV region in the simulated DBB map:
#: above the weight stream (from ``traces.WEIGHT_REGION`` = 0x0, capped
#: by the oracle at this base) and below the co-runner regions at
#: 0x4000_0000+.  The exact segment engine carries segment bases as
#: int32, so every serving region must stay under 2**31.
KV_REGION = 0x2000_0000

#: Recurrent/cross state region — one aligned span per slot, between
#: the KV pool and the co-runner regions.
STATE_REGION = 0x3800_0000


class OutOfBlocksError(RuntimeError):
    """The pool cannot cover a reservation — admission must wait."""


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """One request's page mapping (immutable snapshot)."""
    rid: int
    block_ids: tuple[int, ...]
    tokens: int


class PagedKVCache:
    """Block pool + per-request block tables over a simulated region.

    ``token_bytes`` is the marginal KV bytes per decoded token
    (``DecodeWorkingSet.kv_token_bytes``); block byte spans are rounded
    up to the LLC block size (64 B) so segments stay burst-aligned.
    """

    def __init__(self, *, num_blocks: int, block_size: int,
                 token_bytes: int, region_base: int = KV_REGION):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)          # tokens per block
        self.token_bytes = max(1, int(token_bytes))
        raw = self.block_size * self.token_bytes
        self.block_bytes = -(-raw // 64) * 64      # burst/line aligned
        self.region_base = int(region_base)
        last = self.region_base + self.num_blocks * self.block_bytes
        if self.region_base == KV_REGION and last > STATE_REGION:
            raise ValueError(
                f"KV pool ({last:#x}) spans into the per-slot state "
                f"region at {STATE_REGION:#x}; shrink num_blocks or "
                "rebase the pool")
        if last >= 1 << 31:
            raise ValueError(
                f"KV pool end {last:#x} exceeds the segment engine's "
                "int32 address range; shrink num_blocks or rebase the "
                "region")
        # LIFO free list; pop() hands out the lowest ids first so fresh
        # pools produce deterministic, compact address maps.
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._tables: dict[int, list[int]] = {}
        self._tokens: dict[int, int] = {}
        self._reserved: dict[int, int] = {}        # rid -> blocks reserved

    # -- capacity ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        return -(-max(0, int(tokens)) // self.block_size)

    def can_admit(self, total_tokens: int) -> bool:
        return self.blocks_for(total_tokens) <= self.free_blocks

    # -- lifecycle ---------------------------------------------------------
    def admit(self, rid: int, prompt_tokens: int, max_new: int) -> BlockTable:
        """Reserve every block the request can ever touch and record its
        prompt as written.  Raises ``OutOfBlocksError`` if the pool
        cannot cover the reservation, ``ValueError`` on a duplicate rid.
        """
        if rid in self._tables:
            raise ValueError(f"request {rid} already admitted")
        if prompt_tokens <= 0:
            raise ValueError("prompt must be at least one token")
        need = self.blocks_for(prompt_tokens + max(0, max_new))
        if need > self.free_blocks:
            raise OutOfBlocksError(
                f"request {rid} needs {need} blocks, pool has "
                f"{self.free_blocks} free")
        self._tables[rid] = [self._free.pop() for _ in range(need)]
        self._tokens[rid] = int(prompt_tokens)
        self._reserved[rid] = need
        return self.table(rid)

    def append(self, rid: int, n: int = 1) -> BlockTable:
        """Record n decoded tokens written into the reservation."""
        if rid not in self._tables:
            raise KeyError(f"request {rid} not admitted")
        t = self._tokens[rid] + int(n)
        if self.blocks_for(t) > self._reserved[rid]:
            raise OutOfBlocksError(
                f"request {rid} wrote past its reservation "
                f"({t} tokens > {self._reserved[rid]} blocks)")
        self._tokens[rid] = t
        return self.table(rid)

    def release(self, rid: int) -> None:
        """Return every block of a finished request to the free list."""
        blocks = self._tables.pop(rid)
        del self._tokens[rid], self._reserved[rid]
        self._free.extend(reversed(blocks))   # LIFO: reuse hottest first

    # -- views -------------------------------------------------------------
    def table(self, rid: int) -> BlockTable:
        return BlockTable(rid=rid, block_ids=tuple(self._tables[rid]),
                          tokens=self._tokens[rid])

    def live_requests(self) -> tuple[int, ...]:
        return tuple(sorted(self._tables))

    def block_address(self, block_id: int) -> int:
        return self.region_base + int(block_id) * self.block_bytes

    def read_segments(self, rid: int, *, tokens: int | None = None) -> list:
        """Compressed DBB read segments covering the request's written
        tokens (one 32 B-burst run per block; the last block partial).
        ``tokens`` caps the read below the written length (windowed
        working sets)."""
        written = self._tokens[rid]
        t = written if tokens is None else min(int(tokens), written)
        segs = []
        left = t
        for bid in self._tables[rid]:
            if left <= 0:
                break
            in_block = min(left, self.block_size)
            n_bytes = in_block * self.token_bytes
            segs.append(traces.Segment(
                self.block_address(bid), traces.BURST_BYTES,
                -(-n_bytes // traces.BURST_BYTES), f"kv{rid}"))
            left -= in_block
        return segs

    # -- invariants --------------------------------------------------------
    def check_partition(self) -> None:
        """Free list ∪ block tables must partition [0, num_blocks) with
        no block appearing twice."""
        seen: dict[int, str] = {}
        for b in self._free:
            if b in seen:
                raise AssertionError(f"block {b} twice in free list")
            seen[b] = "free"
        for rid, blocks in self._tables.items():
            for b in blocks:
                if b in seen:
                    raise AssertionError(
                        f"block {b} aliased: {seen[b]} and request {rid}")
                seen[b] = f"req{rid}"
        if len(seen) != self.num_blocks:
            missing = set(range(self.num_blocks)) - set(seen)
            raise AssertionError(f"blocks leaked: {sorted(missing)[:8]}")

    # -- checkpoint --------------------------------------------------------
    def snapshot(self) -> dict:
        return {"free": list(self._free),
                "tables": {r: list(b) for r, b in self._tables.items()},
                "tokens": dict(self._tokens),
                "reserved": dict(self._reserved)}

    def restore(self, snap: dict) -> None:
        self._free = [int(b) for b in snap["free"]]
        self._tables = {int(r): [int(b) for b in bs]
                        for r, bs in snap["tables"].items()}
        self._tokens = {int(r): int(t) for r, t in snap["tokens"].items()}
        self._reserved = {int(r): int(n)
                          for r, n in snap["reserved"].items()}
        self.check_partition()

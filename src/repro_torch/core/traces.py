"""Run-length-compressed NVDLA DBB traces.

A full YOLOv3 frame is ~60M DBB bursts; materializing it as a per-access
array (let alone scanning it serially) is unusable.  But the DBB traffic
is *structured*: every AccelOp reads its weights, streams its ifmap and
writes its ofmap as byte-sequential 32 B bursts from a handful of base
addresses.  This module expresses that stream exactly as ``Segment``
records — ``(base, stride, count)`` arithmetic progressions of byte
addresses — generated straight from the command stream that
``repro_torch.core.runtime`` compiles out of ``yolov3.LAYERS``:

* weights live in a packed read-only region, re-streamed once per tile
  pass (``weight_passes`` segments over the same bytes — real temporal
  reuse the LLC can catch);
* feature maps ping-pong between two activation regions (the producer's
  ofmap region is the consumer's ifmap region);
* the DBB arbiter interleaves the three streams; ``interleave`` models
  that by splitting segments into round-robin chunks at a configurable
  burst granularity (the compressed simulator falls back from the
  closed form to its per-set scan exactly at these interleave points).

``repro_torch.core.sweep.segment_lane_hit_counts`` consumes these
directly; ``expand`` materializes the identical per-access byte trace
for parity testing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.runtime import AccelOp, CommandStream, compile_network
from repro_torch.utils.env import DRAM_ADDR_BITS

BURST_BYTES = 32       # NVDLA DBB minimum burst (paper sec. 4.1)

# Segment constructors reject addresses past DRAM_ADDR_BITS (40 bits,
# utils.env) — an address that "works" only because numpy int64 happens
# to hold it is a generator bug, not a bigger DRAM.

# DBB address map: weights packed from 0, activations ping-pong in two
# regions well above the weight heap (YOLOv3 needs ~62 MiB of weights
# and < 16 MiB per feature map).  The regions are staggered by distinct
# DRAM-row offsets (row = 2 KiB, 32 banks -> 64 KiB bank-rotation
# period): concurrent sequential streams advance through banks in
# lockstep, and with bank-aligned bases they would all ride the *same*
# bank forever, each interleave point closing the others' open row — an
# address-map pathology real allocators don't produce.
WEIGHT_REGION = 0x0000_0000            # bank offset  0
FMAP_REGION_A = 0x1000_0000 + 11 * 2048   # bank offset 11
FMAP_REGION_B = 0x1800_0000 + 22 * 2048   # bank offset 22


@dataclasses.dataclass(frozen=True)
class Segment:
    """`count` bursts at `base`, `base+stride`, ... (byte addresses)."""
    base: int
    stride: int
    count: int
    stream: str = ""           # "weight" | "ifmap" | "ofmap" (labelling)

    def __post_init__(self):
        if self.count < 0:
            raise ValueError(
                f"segment count must be >= 0, got {self.count} — a "
                "negative burst count has no trace meaning; clip the "
                "generator's arithmetic (traces.window drops empties)")
        if self.stride < 0:
            raise ValueError(
                f"segment stride must be >= 0, got {self.stride} — "
                "descending streams are not representable; emit the "
                "ascending run and reorder at the consumer")
        if self.count > 0:
            if self.stride == 0:
                raise ValueError(
                    "segment stride must be positive for a non-empty "
                    "segment — a repeated single address is not a "
                    "compressible sequential burst stream")
            if self.base < 0:
                raise ValueError(
                    f"segment base must be >= 0, got {self.base:#x} — "
                    "byte addresses are physical DBB addresses")
            last = self.base + (self.count - 1) * self.stride
            if last >= 1 << DRAM_ADDR_BITS:
                raise ValueError(
                    f"segment end address {last:#x} exceeds the "
                    f"{DRAM_ADDR_BITS}-bit DRAM address space "
                    f"({1 << DRAM_ADDR_BITS:#x}) — rebase the trace or "
                    "shrink count/stride; see traces.DRAM_ADDR_BITS")

    @property
    def bytes(self) -> int:
        return self.count * self.stride

    def split(self, chunk_bursts: int) -> list["Segment"]:
        """Cut into chunks of at most `chunk_bursts` bursts.  A zero- (or
        negative-) count segment yields no chunks — never a zero-count
        chunk that would expand to an empty array."""
        out = []
        done = 0
        while done < self.count:
            n = min(chunk_bursts, self.count - done)
            out.append(Segment(self.base + done * self.stride,
                               self.stride, n, self.stream))
            done += n
        return out


def segment_tuple(seg) -> tuple[int, int, int]:
    """Normalize a ``Segment`` or raw ``(base, stride, count)`` tuple —
    the one definition of the segment protocol every compressed-trace
    consumer (LLC engine, DRAM row model, sweep lanes) unpacks through."""
    return (seg if isinstance(seg, tuple)
            else (seg.base, seg.stride, seg.count))


def _bursts(n_bytes: int) -> int:
    return -(-n_bytes // BURST_BYTES)


def op_segments(op: AccelOp, weight_base: int, ifmap_base: int,
                ofmap_base: int) -> list[Segment]:
    """One AccelOp's DBB streams as segments, in issue order: each tile
    pass re-streams the weights, then the ifmap share, then the ofmap
    share (matching the traffic accounting in ``repro_torch.core.runtime``)."""
    segs: list[Segment] = []
    passes = max(1, op.weight_passes)
    w_per_pass = op.weight_traffic // passes
    i_total, o_total = op.ifmap_traffic, op.ofmap_traffic
    i_done = o_done = 0
    for p in range(passes):
        if w_per_pass:
            segs.append(Segment(weight_base, BURST_BYTES,
                                _bursts(w_per_pass), "weight"))
        i_share = i_total * (p + 1) // passes - i_done
        o_share = o_total * (p + 1) // passes - o_done
        if i_share:
            segs.append(Segment(ifmap_base + i_done, BURST_BYTES,
                                _bursts(i_share), "ifmap"))
        if o_share:
            segs.append(Segment(ofmap_base + o_done, BURST_BYTES,
                                _bursts(o_share), "ofmap"))
        i_done += i_share
        o_done += o_share
    return segs


def network_op_segments(stream: CommandStream | None = None,
                        max_ops: int | None = None) -> list[list[Segment]]:
    """Per-AccelOp DBB streams over the shared address map — the same
    segments ``network_trace`` emits, kept grouped by op so per-layer
    consumers (the sim-driven ``repro_torch.core.accelerator`` hit rates) can
    attribute hits to the op that issued them.

    Weight regions are packed in layer order; feature maps ping-pong
    between two regions so a consumer reads where its producer wrote.
    """
    stream = stream or compile_network()
    ops = stream.accel_ops[:max_ops] if max_ops else stream.accel_ops
    per_op: list[list[Segment]] = []
    w_cursor = WEIGHT_REGION
    regions = (FMAP_REGION_A, FMAP_REGION_B)
    for i, op in enumerate(ops):
        ifmap_base = regions[i % 2]
        ofmap_base = regions[(i + 1) % 2]
        per_op.append(op_segments(op, w_cursor, ifmap_base, ofmap_base))
        passes = max(1, op.weight_passes)
        w_cursor += op.weight_traffic // passes
    return per_op


def network_trace(stream: CommandStream | None = None,
                  max_ops: int | None = None) -> list[Segment]:
    """The whole accelerated network's DBB stream, compressed (the
    flattened ``network_op_segments``)."""
    return [seg for op_segs in network_op_segments(stream, max_ops)
            for seg in op_segs]


def interleave(segments: list[Segment], chunk_bursts: int = 64
               ) -> list[Segment]:
    """Round-robin the streams at `chunk_bursts` granularity — the DBB
    arbiter's view.  Segments with distinct `stream` labels alternate;
    order within a stream is preserved.  The result is still a valid
    compressed trace (many short segments)."""
    lanes: dict[str, list[Segment]] = {}
    for seg in segments:
        lanes.setdefault(seg.stream or "_", []).extend(
            seg.split(chunk_bursts))
    out: list[Segment] = []
    queues = list(lanes.values())
    idx = [0] * len(queues)
    while True:
        progressed = False
        for q, queue in enumerate(queues):
            if idx[q] < len(queue):
                out.append(queue[idx[q]])
                idx[q] += 1
                progressed = True
        if not progressed:
            return out


def window(segments: list[Segment], max_bursts: int) -> list[Segment]:
    """Clip a compressed trace to its first `max_bursts` accesses.

    Zero-count segments (an input clipped at an exact chunk boundary, or
    an already-empty segment) are dropped rather than kept as count-0
    records: downstream consumers concatenate ``expand``-ed pieces and a
    degenerate segment would contribute an empty array with nothing to
    pin its dtype or base address."""
    out: list[Segment] = []
    left = max_bursts
    for seg in segments:
        if left <= 0:
            break
        n = min(seg.count, left)
        if n > 0:
            out.append(dataclasses.replace(seg, count=n))
            left -= n
    return out


def total_bursts(segments: list[Segment]) -> int:
    return sum(s.count for s in segments)


def expand(segments: list[Segment]) -> np.ndarray:
    """Materialize the exact per-access byte-address trace (int64 numpy;
    parity-test oracle — never needed on the fast path)."""
    parts = [s.base + np.arange(s.count, dtype=np.int64) * s.stride
             for s in segments if s.count > 0]
    if not parts:
        return np.zeros((0,), np.int64)
    return np.concatenate(parts)


def default_dbb_window(max_bursts: int = 4096, chunk_bursts: int = 16,
                       layer_index: int = 40) -> list[Segment]:
    """A representative DBB window for sweeps: a mid-network conv layer's
    weight/ifmap/ofmap streams, arbiter-interleaved."""
    stream = compile_network()
    ops = stream.accel_ops
    op = ops[min(layer_index, len(ops) - 1)]
    segs = op_segments(op, WEIGHT_REGION, FMAP_REGION_A, FMAP_REGION_B)
    return window(interleave(segs, chunk_bursts), max_bursts)

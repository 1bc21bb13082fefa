"""Systolic-array NPU model: the second accelerator backend — the
PyTorch port of the reference's ``core/npu``, framework-free except for
the simulated hit rates, which replay on ``device``.

The paper evaluates one accelerator (NVDLA) behind the shared LLC +
DRAM; this module adds an architecturally different second point — a
parameterized weight-stationary systolic GEMM array (rows x cols PEs,
explicit input/weight/accumulator SRAMs) — to prove the segment stack
is accelerator-agnostic.  The NPU's command stream is a list of
``GemmOp``s from the repo's own model zoo (transformer/mamba2 decode
projections, the whisper encoder, YOLOv3 conv-as-GEMM via im2col), and
it compiles to exactly the same currency NVDLA traces use: compressed
``(base, stride, count)`` DBB segments (``repro_torch.core.traces.Segment``)
that replay through ``core.cache`` / ``core.dram`` / ``core.socsim``
and the lane-batched sweep lanes *unchanged*.

Dataflow (weight-stationary):

* a weight tile of ``rows x cols`` elements is held in the PE grid
  (rows = the K/reduction dim, cols = the N/output dim); input rows
  stream through, one M row per cycle once the pipeline fills;
* the K dimension is tiled by ``rows``, N by ``cols``; the M dimension
  is tiled so the streamed input tile fits the input SRAM and the
  partial sums fit the accumulator SRAM
  (``m_tile = min(ifm_buf/(rows*elem), acc_buf/(cols*acc))``);
* per (n, m) tile visit the k loop runs innermost, so the weight
  k-stripe and the input k-run are each ONE contiguous segment —
  operands are packed tile-major (every tile's bytes aligned up to the
  32 B DBB burst), which is what keeps whole-workload traces at
  O(tile-visits) segments instead of O(tiles).

Reuse regimes (the NVDLA ``weight_passes`` analogy, per operand):

* a weight stripe (K x n_tile bytes) that fits the weight SRAM is
  fetched once; otherwise it re-streams once per M block —
  ``weight_passes[n] = n_m`` — the temporal-reuse pattern whose LLC
  behaviour the paper measures on NVDLA;
* the input operand is fetched once if all of A fits the input SRAM,
  else once per N stripe; outputs are written exactly once.

Traffic and compute-cycle totals are **visit-order invariant** by
construction: they are sums over the tile set, and first-fetch
accounting follows the reuse regime, not the loop index — the
hypothesis suites replay random visit permutations to pin that.
Timing mirrors ``repro_torch.core.accelerator``: per-op
``compute = sum over tiles of (m + k + n + overhead)``, memory from
burst latency / MLP with a DRAM bandwidth floor, hit rates either the
closed-form stream model or — ``mode="simulated"`` — the exact segment
engine's per-op measurements folded by stream.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import traces
from repro_torch.core.accelerator import (
    MemSystemConfig,
    _fold_op_stream_rates,
    _stream_hit_rate,
)
from repro_torch.core.traces import BURST_BYTES, Segment
from repro_torch.utils.env import default_device

# NPU DBB address map.  Weights pack from traces.WEIGHT_REGION (0x0)
# with a hard heap budget; feature maps ping-pong between two regions
# placed above the heap and *below* the sweep co-runner regions at
# 0x4000_0000 (repro_torch.core.sweep._corunner_spans) so campaign
# lanes never alias, and below int32 so a 32-bit lane engine's
# metadata holds every address.  Bases are staggered by distinct 2 KiB
# DRAM-row offsets, same rationale as traces.FMAP_REGION_A/B.
NPU_WEIGHT_BUDGET = 0x2000_0000            # 512 MiB weight heap
NPU_FMAP_REGION_A = 0x2000_0000 + 13 * 2048
NPU_FMAP_REGION_B = 0x2C00_0000 + 26 * 2048


@dataclasses.dataclass(frozen=True)
class NPUConfig:
    """One systolic-array instance: PE grid + SRAM sizing + timing."""
    rows: int = 16                 # K (reduction) dimension of the grid
    cols: int = 16                 # N (output) dimension of the grid
    ifm_buf_bytes: int = 64 * 1024
    wgt_buf_bytes: int = 64 * 1024
    acc_buf_bytes: int = 32 * 1024
    elem_bytes: int = 1            # int8 operands (the paper's int8 path)
    acc_bytes: int = 4             # int32 accumulators
    freq_hz: float = 3.2e9         # shared SoC clock (paper FireSim config)
    mlp: float = 3.1               # DBB memory-level parallelism
    tile_overhead_cycles: int = 8  # weight-load / drain bubble per tile
    op_overhead_cycles: int = 4000  # descriptor programming per GemmOp

    def __post_init__(self):
        for f in ("rows", "cols", "ifm_buf_bytes", "wgt_buf_bytes",
                  "acc_buf_bytes", "elem_bytes", "acc_bytes"):
            if getattr(self, f) <= 0:
                raise ValueError(f"NPUConfig.{f} must be positive, got "
                                 f"{getattr(self, f)}")

    @property
    def m_tile(self) -> int:
        """Input rows streamed per accumulation block: bounded by the
        input SRAM (one k-tile column of the streamed operand) and the
        accumulator SRAM (one n-tile row of partials)."""
        by_ifm = self.ifm_buf_bytes // (self.rows * self.elem_bytes)
        by_acc = self.acc_buf_bytes // (self.cols * self.acc_bytes)
        return max(1, min(by_ifm, by_acc))

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class GemmOp:
    """One tiled GEMM: ``(m x k) @ (k x n)`` — the NPU's unit of work
    (a conv layer arrives here already im2col-lowered)."""
    name: str
    m: int
    k: int
    n: int

    def __post_init__(self):
        if self.m <= 0 or self.k <= 0 or self.n <= 0:
            raise ValueError(f"GemmOp dims must be positive, got "
                             f"m={self.m} k={self.k} n={self.n}")

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


def _align(nbytes: int) -> int:
    """Tile bytes aligned up to the 32 B DBB burst — the packing rule
    that keeps every tile's byte run an exact whole number of bursts
    (so segment expansion covers operand footprints with no gaps and
    no fractional-burst overlaps)."""
    return -(-nbytes // BURST_BYTES) * BURST_BYTES


def _sizes(total: int, tile: int) -> tuple[int, ...]:
    full, rem = divmod(total, tile)
    return (tile,) * full + ((rem,) if rem else ())


class GemmSchedule:
    """Host-side schedule of one ``GemmOp`` on one ``NPUConfig``: tile
    block sizes, packed operand layouts (byte offsets), reuse regimes,
    and the closed-form traffic/cycle totals.  Pure function of
    (op, cfg); memoized via :func:`schedule`."""

    def __init__(self, op: GemmOp, cfg: NPUConfig):
        self.op, self.cfg = op, cfg
        self.m_szs = _sizes(op.m, cfg.m_tile)
        self.k_szs = _sizes(op.k, cfg.rows)
        self.n_szs = _sizes(op.n, cfg.cols)
        self.n_m, self.n_k, self.n_n = (len(self.m_szs), len(self.k_szs),
                                        len(self.n_szs))
        e = cfg.elem_bytes
        # weight layout: stripe-major (n), k-tiles contiguous in-stripe
        self.stripe_bytes = tuple(
            sum(_align(k * n * e) for k in self.k_szs) for n in self.n_szs)
        self.stripe_off = _cum(self.stripe_bytes)
        # input layout: m-block-major, k-tiles contiguous in-block
        self.mblock_bytes = tuple(
            sum(_align(m * k * e) for k in self.k_szs) for m in self.m_szs)
        self.mblock_off = _cum(self.mblock_bytes)
        # output layout: n-major, m-minor (canonical, order-independent)
        self.otile_bytes = tuple(
            tuple(_align(m * n * e) for m in self.m_szs)
            for n in self.n_szs)
        col = tuple(sum(row) for row in self.otile_bytes)
        col_off = _cum(col)
        self.otile_off = tuple(
            tuple(col_off[j] + off for off in _cum(row))
            for j, row in enumerate(self.otile_bytes))
        # reuse regimes (order-invariant by definition — see module doc)
        self.weight_passes = tuple(
            1 if sb <= cfg.wgt_buf_bytes else self.n_m
            for sb in self.stripe_bytes)
        self.weight_footprint = sum(self.stripe_bytes)
        self.ifmap_footprint = sum(self.mblock_bytes)
        self.ofmap_footprint = sum(col)
        self.ifmap_passes = (1 if self.ifmap_footprint <= cfg.ifm_buf_bytes
                             else self.n_n)

    @property
    def weight_traffic(self) -> int:
        return sum(sb * p for sb, p in zip(self.stripe_bytes,
                                           self.weight_passes))

    @property
    def ifmap_traffic(self) -> int:
        return self.ifmap_footprint * self.ifmap_passes

    @property
    def ofmap_traffic(self) -> int:
        return self.ofmap_footprint

    @property
    def total_tiles(self) -> int:
        return self.n_m * self.n_k * self.n_n

    @property
    def compute_cycles(self) -> int:
        """Sum over every (m, k, n) tile of its systolic pass —
        ``m_sz`` streaming cycles + ``k_sz + n_sz`` fill/drain + the
        fixed tile overhead.  A sum over the tile *set*, so any visit
        order totals identically (the tiling-invariance property)."""
        op, c = self.op, self.cfg.tile_overhead_cycles
        return (self.n_n * self.n_k * op.m + self.n_m * self.n_n * op.k
                + self.n_m * self.n_k * op.n + self.total_tiles * c)

    def visits(self, order="nm") -> list[tuple[int, int]]:
        """The (n, m) tile-visit sequence.  ``"nm"`` is the canonical
        weight-stationary order (n outer); ``"mn"`` streams m outer; an
        explicit sequence of (n, m) pairs must be a permutation of the
        full visit set."""
        if order == "nm":
            return [(n, m) for n in range(self.n_n)
                    for m in range(self.n_m)]
        if order == "mn":
            return [(n, m) for m in range(self.n_m)
                    for n in range(self.n_n)]
        visits = [(int(n), int(m)) for n, m in order]
        if sorted(visits) != self.visits("nm"):
            raise ValueError(
                f"explicit visit order must be a permutation of the "
                f"{self.n_n}x{self.n_m} (n, m) tile grid")
        return visits


def _cum(sizes) -> tuple[int, ...]:
    out, acc = [], 0
    for s in sizes:
        out.append(acc)
        acc += s
    return tuple(out)


@functools.lru_cache(maxsize=4096)
def schedule(op: GemmOp, cfg: NPUConfig) -> GemmSchedule:
    return GemmSchedule(op, cfg)


# --------------------------------------------------------------------------
# command stream -> compressed DBB segments
# --------------------------------------------------------------------------
def op_segments(op: GemmOp, cfg: NPUConfig, weight_base: int,
                ifmap_base: int, ofmap_base: int,
                order="nm") -> list[Segment]:
    """One GemmOp's DBB streams as compressed segments in tile-visit
    order: per (n, m) visit, the weight k-stripe (re-streamed or
    first-fetch per its reuse regime), the input k-run, and the output
    tile write — each one contiguous segment (see module doc).  The
    segment sizes are exactly the schedule's packed layouts, so the
    per-stream traffic equals ``GemmSchedule.{weight,ifmap,ofmap}_
    traffic`` bytes for *any* visit order."""
    s = schedule(op, cfg)
    segs: list[Segment] = []
    seen_n: set[int] = set()
    seen_m: set[int] = set()
    for n, m in s.visits(order):
        if s.weight_passes[n] > 1 or n not in seen_n:
            segs.append(Segment(weight_base + s.stripe_off[n], BURST_BYTES,
                                s.stripe_bytes[n] // BURST_BYTES, "weight"))
        if s.ifmap_passes > 1 or m not in seen_m:
            segs.append(Segment(ifmap_base + s.mblock_off[m], BURST_BYTES,
                                s.mblock_bytes[m] // BURST_BYTES, "ifmap"))
        segs.append(Segment(ofmap_base + s.otile_off[n][m], BURST_BYTES,
                            s.otile_bytes[n][m] // BURST_BYTES, "ofmap"))
        seen_n.add(n)
        seen_m.add(m)
    return segs


def _iter_op_segments(ops, cfg: NPUConfig, order="nm"):
    """Lazily yield each op's segment list over the NPU address map —
    the shared walk behind ``workload_op_segments`` / ``npu_chunks``
    (lazy so windowed consumers stop compiling once they have enough
    bursts)."""
    fmap_span = NPU_FMAP_REGION_B - NPU_FMAP_REGION_A
    w_cursor = traces.WEIGHT_REGION
    regions = (NPU_FMAP_REGION_A, NPU_FMAP_REGION_B)
    for i, op in enumerate(ops):
        s = schedule(op, cfg)
        if w_cursor + s.weight_footprint > \
                traces.WEIGHT_REGION + NPU_WEIGHT_BUDGET:
            raise ValueError(
                f"op {op.name!r} overruns the NPU weight heap: cursor "
                f"{w_cursor:#x} + {s.weight_footprint:#x} bytes exceeds "
                f"the {NPU_WEIGHT_BUDGET:#x}-byte budget — shrink the "
                "workload or split it into frames")
        if max(s.ifmap_footprint, s.ofmap_footprint) > fmap_span:
            raise ValueError(
                f"op {op.name!r} feature map "
                f"({max(s.ifmap_footprint, s.ofmap_footprint):#x} bytes) "
                f"overruns the {fmap_span:#x}-byte NPU fmap region")
        yield op_segments(op, cfg, w_cursor, regions[i % 2],
                          regions[(i + 1) % 2], order)
        w_cursor += s.weight_footprint


def workload_op_segments(ops, cfg: NPUConfig | None = None,
                         order="nm") -> list[list[Segment]]:
    """Per-op DBB streams over the NPU address map: weights packed from
    ``traces.WEIGHT_REGION`` in op order (heap budget enforced),
    feature maps ping-ponging between the two NPU regions so a
    chain-shaped workload reads where its producer wrote (the same
    approximation ``traces.network_op_segments`` makes).  Raises
    ``ValueError`` when an operand overruns its region — and
    ``traces.Segment`` itself rejects anything past the 40-bit DBB
    address space, so a runaway GemmOp can never emit a trace the DRAM
    model cannot address."""
    return list(_iter_op_segments(ops, cfg or NPUConfig(), order))


def workload_trace(ops, cfg: NPUConfig | None = None,
                   order="nm") -> list[Segment]:
    """The whole workload's compressed DBB stream at stream granularity
    (the flattened ``workload_op_segments``)."""
    return [seg for op_segs in workload_op_segments(ops, cfg, order)
            for seg in op_segs]


def npu_chunks(ops, cfg: NPUConfig | None = None, chunk_bursts: int = 16,
               order="nm", max_bursts: int | None = None) -> list[Segment]:
    """The NPU command stream compiled to arbiter-interleaved
    ``(base, stride, count)`` DBB segments: per op, the weight/input/
    output streams round-robin at ``chunk_bursts`` granularity
    (``traces.interleave`` — the same DBB arbiter model NVDLA windows
    use), ops back to back.  ``max_bursts`` stops compiling once that
    many bursts have been emitted (the clip still lands on an exact
    burst via ``traces.window``) — full-workload interleaved streams
    run to millions of chunks, and windowed consumers only need a
    prefix.  This is the campaign/sweep trace source for
    ``backend="npu"`` points."""
    out: list[Segment] = []
    emitted = 0
    for op_segs in _iter_op_segments(ops, cfg or NPUConfig(), order):
        chunked = traces.interleave(op_segs, chunk_bursts)
        out.extend(chunked)
        emitted += sum(s.count for s in chunked)
        if max_bursts is not None and emitted >= max_bursts:
            break
    return traces.window(out, max_bursts) if max_bursts is not None else out


def default_npu_window(name: str = "yolov3", *,
                       cfg: NPUConfig | None = None,
                       max_bursts: int = 4096,
                       chunk_bursts: int = 16) -> list[Segment]:
    """A representative NPU DBB window for sweeps: the named zoo
    workload's interleaved stream clipped to its first ``max_bursts``
    accesses (the NPU analogue of ``traces.default_dbb_window``)."""
    return npu_chunks(workload(name), cfg, chunk_bursts,
                      max_bursts=max_bursts)


# --------------------------------------------------------------------------
# model-zoo GEMM workloads
# --------------------------------------------------------------------------
def yolov3_gemms(max_layers: int | None = None) -> tuple[GemmOp, ...]:
    """YOLOv3's conv layers as im2col GEMMs: M = out_h*out_w spatial
    positions, K = cin*k*k patch elements, N = cout filters — the same
    66 GOP frame the NVDLA path runs, re-lowered for a GEMM engine."""
    from repro_torch.core import yolov3

    ops = tuple(GemmOp(f"conv{la.index}", m=la.out_h * la.out_w,
                       k=la.cin * la.ksize * la.ksize, n=la.cout)
                for la in yolov3.LAYERS if la.kind == "conv")
    return ops[:max_layers] if max_layers else ops


def transformer_decode_gemms(arch: str = "qwen2-0.5b", *, batch: int = 8,
                             include_head: bool = True
                             ) -> tuple[GemmOp, ...]:
    """One decode step's projection GEMMs (M = decode batch): QKV,
    attention output, the (gated) MLP pair per layer, plus the LM
    head."""
    from repro_torch.configs import get_config

    c = get_config(arch)
    qkv_n = (c.num_heads + 2 * c.num_kv_heads) * c.head_dim
    up_n = (2 if c.gated_mlp else 1) * c.d_ff
    ops: list[GemmOp] = []
    for i in range(c.num_layers):
        ops += [GemmOp(f"l{i}.qkv", batch, c.d_model, qkv_n),
                GemmOp(f"l{i}.attn_out", batch,
                       c.num_heads * c.head_dim, c.d_model),
                GemmOp(f"l{i}.mlp_up", batch, c.d_model, up_n),
                GemmOp(f"l{i}.mlp_down", batch, c.d_ff, c.d_model)]
    if include_head:
        ops.append(GemmOp("lm_head", batch, c.d_model, c.vocab_size))
    return tuple(ops)


def mamba2_decode_gemms(arch: str = "mamba2-130m", *, batch: int = 8
                        ) -> tuple[GemmOp, ...]:
    """One mamba-2 decode step's projections: the fused input
    projection (x/z branches + B/C + dt heads) and the output
    projection per layer (the SSD state update itself is elementwise —
    not GEMM work)."""
    from repro_torch.configs import get_config

    c = get_config(arch)
    in_n = (2 * c.ssm_d_inner + 2 * c.ssm_ngroups * c.ssm_state
            + c.ssm_nheads)
    ops: list[GemmOp] = []
    for i in range(c.num_layers):
        ops += [GemmOp(f"l{i}.in_proj", batch, c.d_model, in_n),
                GemmOp(f"l{i}.out_proj", batch, c.ssm_d_inner, c.d_model)]
    return tuple(ops)


def whisper_encoder_gemms(arch: str = "whisper-tiny"
                          ) -> tuple[GemmOp, ...]:
    """The whisper audio encoder's GEMMs over a 30 s window: M =
    encoder_len frames through self-attention QKV/out and the MLP pair
    per encoder layer — a large-M workload, unlike decode."""
    from repro_torch.configs import get_config

    c = get_config(arch)
    d_attn = c.num_heads * c.head_dim
    ops: list[GemmOp] = []
    for i in range(c.num_encoder_layers):
        ops += [GemmOp(f"enc{i}.qkv", c.encoder_len, c.d_model, 3 * d_attn),
                GemmOp(f"enc{i}.attn_out", c.encoder_len, d_attn, c.d_model),
                GemmOp(f"enc{i}.mlp_up", c.encoder_len, c.d_model, c.d_ff),
                GemmOp(f"enc{i}.mlp_down", c.encoder_len, c.d_ff,
                       c.d_model)]
    return tuple(ops)


WORKLOADS = {
    "yolov3": yolov3_gemms,
    "transformer_decode": transformer_decode_gemms,
    "mamba2_decode": mamba2_decode_gemms,
    "whisper_encoder": whisper_encoder_gemms,
}


@functools.lru_cache(maxsize=8)
def workload(name: str) -> tuple[GemmOp, ...]:
    """The named zoo workload at its default scale (memoized — config
    lookups and the GEMM lists are pure)."""
    if name not in WORKLOADS:
        raise ValueError(f"unknown NPU workload {name!r}; "
                         f"known: {sorted(WORKLOADS)}")
    return WORKLOADS[name]()


# --------------------------------------------------------------------------
# timing model (mirrors repro_torch.core.accelerator)
# --------------------------------------------------------------------------
def op_cycles(op: GemmOp, cfg: NPUConfig, mem: MemSystemConfig,
              hit_rates: tuple[float, float, float] | None = None) -> dict:
    """One GemmOp's cycle breakdown on the NPU behind the shared memory
    system — the same structure as ``accelerator.op_cycles``:
    ``max(compute, memory) + overhead`` with memory from burst latency
    over the measured-or-modeled (weight, ifmap, ofmap) LLC hit rates,
    floored by the DRAM bandwidth share."""
    s = schedule(op, cfg)
    compute = float(s.compute_cycles)

    t_dram = mem.t_dram_cycles + mem.extra_dram_latency + mem.bus_delay_cycles
    t_llc = mem.t_llc_cycles + mem.bus_delay_cycles
    if hit_rates is not None:
        scale = 1.0 - mem.llc_eviction_prob
        h_w, h_i, h_o = (h * scale for h in hit_rates)
    else:
        h_w = h_i = h_o = _stream_hit_rate(mem)

    def stream_cycles(traffic, h):
        if traffic == 0:
            return 0.0
        lat = h * t_llc + (1.0 - h) * t_dram
        return (traffic / BURST_BYTES) * lat / cfg.mlp

    latency_cycles = (stream_cycles(s.weight_traffic, h_w)
                      + stream_cycles(s.ifmap_traffic, h_i)
                      + stream_cycles(s.ofmap_traffic, h_o))
    miss_bytes = (s.weight_traffic * (1 - h_w)
                  + s.ifmap_traffic * (1 - h_i)
                  + s.ofmap_traffic * (1 - h_o))
    bw_bytes_per_cycle = (mem.dram.peak_bw / cfg.freq_hz) * mem.dram_bw_share
    memory = max(latency_cycles, miss_bytes / bw_bytes_per_cycle)
    total = max(compute, memory) + cfg.op_overhead_cycles
    return {"compute": compute, "memory": memory, "total": total,
            "hit_rates": (h_w, h_i, h_o),
            "utilization": op.macs / (cfg.peak_macs_per_cycle * compute),
            "traffic": (s.weight_traffic, s.ifmap_traffic,
                        s.ofmap_traffic)}


def op_stream_hit_rates(ops, cfg: NPUConfig, mem: MemSystemConfig,
                        max_ops: int | None = None, *, device=None
                        ) -> list[tuple[float, float, float]]:
    """Exact per-op (weight, ifmap, ofmap) LLC hit rates of the NPU
    workload from the segment engine — one pass over the whole
    workload trace with LLC state carried across ops, replayed on
    ``device`` (``cuda`` when None) and folded by stream exactly like
    the NVDLA path (this is what ``mode="simulated"`` feeds
    ``op_cycles``)."""
    from repro_torch.core.cache import simulate_segments

    ops = tuple(ops)[:max_ops] if max_ops else tuple(ops)
    if mem.llc is None:
        return [(0.0, 0.0, 0.0)] * len(ops)
    per_op = workload_op_segments(ops, cfg)
    flat = [s for segs in per_op for s in segs]
    res = simulate_segments(flat, mem.llc, per_segment=True, device=device)
    return _fold_op_stream_rates(per_op, res.per_segment_hits)


def npu_time_s(ops, *, npu: NPUConfig | None = None,
               mem: MemSystemConfig | None = None, mode: str = "model",
               hit_rates: list | None = None, device=None) -> dict:
    """NPU-side workload time — the ``accel_time_s`` twin.
    ``mode="model"`` uses the closed-form sequential-stream hit rates;
    ``mode="simulated"`` measures every op's rates with the exact
    segment simulator on the op's real DBB trace, run on ``device``
    (``hit_rates`` short-circuits the simulation when the caller already
    has them).  ``device`` is resolved first in every mode: None means
    ``cuda`` and raises without a card."""
    dev = default_device(device)
    npu = npu or NPUConfig()
    mem = mem or MemSystemConfig()
    ops = tuple(ops)
    if mode not in ("model", "simulated"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "simulated" and hit_rates is None:
        hit_rates = op_stream_hit_rates(ops, npu, mem, device=dev)
    if hit_rates is not None and len(hit_rates) != len(ops):
        raise ValueError(
            f"{len(hit_rates)} hit-rate tuples for {len(ops)} GEMM ops — "
            "hit_rates must cover every op of this workload")
    if hit_rates is None:
        per_layer = [op_cycles(op, npu, mem) for op in ops]
    else:
        per_layer = [op_cycles(op, npu, mem, hit_rates=hr)
                     for op, hr in zip(ops, hit_rates)]
    cycles = sum(p["total"] for p in per_layer)
    return {
        "cycles": cycles,
        "seconds": cycles / npu.freq_hz,
        "per_layer": per_layer,
        "mode": mode,
        "compute_bound_layers": sum(
            1 for p in per_layer if p["compute"] >= p["memory"]),
    }


def decode_weight_segments(weight_bytes: int, cfg: NPUConfig | None = None,
                           *, m: int = 1, k: int = 4096,
                           base: int = traces.WEIGHT_REGION
                           ) -> list[Segment]:
    """One decode step's parameter read as the NPU would fetch it: the
    active weights modeled as a (m x k x n) GEMM's weight stream under
    the weight-stationary schedule — per-stripe segments, with
    re-stream passes appearing exactly when a stripe outgrows the
    weight SRAM while the batch spans multiple m tiles.  This is the
    serving oracle's ``backend="npu"`` weight stream
    (``repro_torch.serve.oracle``)."""
    cfg = cfg or NPUConfig()
    k = max(1, min(k, weight_bytes))
    n = max(1, -(-weight_bytes // (k * cfg.elem_bytes)))
    op = GemmOp("decode_weights", m=max(1, m), k=k, n=n)
    return [s for s in op_segments(op, cfg, base, NPU_FMAP_REGION_A,
                                   NPU_FMAP_REGION_B)
            if s.stream == "weight"]

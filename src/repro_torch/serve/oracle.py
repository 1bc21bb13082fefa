"""SoC latency oracle: serving steps -> DBB traces -> simulated cycles.

This is where the serving engine closes the loop with the paper's memory
system.  Each scheduler step is lowered to a compressed DBB segment
trace from the model's decode working set (``models.decode_working_set``):

* a weight stream from ``traces.WEIGHT_REGION`` — every active parameter
  read once per decoded token;
* per-slot KV reads over the request's paged blocks (``PagedKVCache``
  addresses), plus a constant recurrent/cross-state read per slot;
* optional BwWrite co-runner lanes (``MixConfig``), the paper's Fig. 6
  interference cores, interleaved at arbiter-chunk granularity.

Decode steps are charged their *steady-state marginal* cost: the step
trace is its own warm prefix (``sweep.step_lane_metrics(...,
warm_prefix=step)``), so working sets that fit the LLC re-hit across
steps and each admitted co-resident request grows the cyclic
re-reference distance.  Prefill steps are charged cold (first touch of
new blocks).  The LLC replay runs on ``device`` (``cuda`` when None).

Cycles convert to seconds at the SoC clock (the paper's 3.2 GHz FireSim
config); results are memoized by the exact trace signature, so a steady
occupancy pattern costs one simulation.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import traces
from repro_torch.core.cache import LLCConfig
from repro_torch.core.dram import DRAMConfig
from repro_torch.core.sweep import LaneMetrics, MixConfig, step_lane_metrics
from repro_torch.serve.kvcache import KV_REGION, STATE_REGION, PagedKVCache
from repro_torch.utils.env import default_device

SOC_FREQ_HZ = 3.2e9      # shared CPU/NVDLA clock in the paper's config

# the accelerator backends whose weight stream the oracle lowers; the
# reference's "npu" backend waits for the port of core/npu (ROADMAP)
SUPPORTED_BACKENDS = ("nvdla",)


@dataclasses.dataclass(frozen=True)
class StepLatency:
    """One scheduler step's simulated cost."""
    cycles: int
    seconds: float
    metrics: LaneMetrics


class SoCLatencyOracle:
    """Maps a serving step's working set to simulated SoC latency.

    Keyword-only configuration, matching the sweep APIs: ``llc=``,
    ``dram=``, ``mix=`` (co-runner interference), ``chunk_bursts=`` (the
    DBB arbiter granularity between the weight stream, each slot's KV
    stream, and co-runner lanes), ``weight_bytes=`` overriding the
    model-derived stream footprint, ``device=`` for the LLC replay.
    """

    def __init__(self, working_set, *, llc: LLCConfig | None = None,
                 dram: DRAMConfig | None = None,
                 mix: MixConfig | None = None,
                 chunk_bursts: int = 256, t_llc_hit: int = 20,
                 freq_hz: float = SOC_FREQ_HZ,
                 weight_bytes: int | None = None,
                 backend: str = "nvdla", device=None):
        if backend == "npu":
            raise NotImplementedError(
                "backend='npu' needs core/npu, not ported yet — ROADMAP, "
                "port queue")
        if backend not in SUPPORTED_BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the oracle "
                             f"speaks {', '.join(SUPPORTED_BACKENDS)}")
        self.ws = working_set
        self.llc = llc or LLCConfig()
        self.dram = dram or DRAMConfig()
        self.mix = mix or MixConfig()
        self.chunk_bursts = int(chunk_bursts)
        self.t_llc_hit = int(t_llc_hit)
        self.freq_hz = float(freq_hz)
        self.backend = backend
        self.device = default_device(device)
        self.weight_bytes = int(weight_bytes if weight_bytes is not None
                                else working_set.weight_bytes)
        if self.weight_bytes >= KV_REGION:
            raise ValueError(
                f"weight stream ({self.weight_bytes:#x} bytes from "
                f"{traces.WEIGHT_REGION:#x}) would overlap the paged-KV "
                f"region at {KV_REGION:#x}; pass weight_bytes= to model "
                "a resident subset")
        self._memo: dict = {}
        self._weight_segs = [traces.Segment(
            traces.WEIGHT_REGION, traces.BURST_BYTES,
            -(-self.weight_bytes // traces.BURST_BYTES), "weight")]

    # -- trace construction ------------------------------------------------
    def _state_segment(self, slot: int) -> traces.Segment | None:
        if not self.ws.state_bytes:
            return None
        span = -(-self.ws.state_bytes // 64) * 64
        base = STATE_REGION + slot * span
        if base + span > 0x4000_0000:
            raise ValueError(
                f"slot {slot} state span ({span:#x} bytes) runs past the "
                "co-runner regions at 0x4000_0000; shrink max_slots or "
                "the recurrent state")
        return traces.Segment(base, traces.BURST_BYTES,
                              -(-self.ws.state_bytes // traces.BURST_BYTES),
                              f"state{slot}")

    def decode_trace(self, kv: PagedKVCache, rids: list[int]) -> list:
        """One decode step's interleaved read trace at the current
        occupancy: the weight stream round-robined against each active
        request's live KV + state reads at arbiter-chunk granularity."""
        streams: list = list(self._weight_segs)
        for slot, rid in enumerate(rids):
            live = self.ws.kv_bytes(kv.table(rid).tokens)
            tokens_live = (live // max(1, self.ws.kv_token_bytes)
                           if self.ws.kv_token_bytes else 0)
            streams.extend(kv.read_segments(rid, tokens=tokens_live))
            st = self._state_segment(slot)
            if st is not None:
                streams.append(st)
        return traces.interleave(streams, chunk_bursts=self.chunk_bursts)

    def prefill_trace(self, kv: PagedKVCache, rids: list[int]) -> list:
        """Prefill writes the admitted prompts' blocks once (plus one
        weight stream for the prompt pass)."""
        streams: list = list(self._weight_segs)
        for rid in rids:
            streams.extend(kv.read_segments(rid))
        return traces.interleave(streams, chunk_bursts=self.chunk_bursts)

    # -- costing -----------------------------------------------------------
    def _cost(self, trace: list, *, steady: bool) -> StepLatency:
        key = (steady, tuple(traces.segment_tuple(s) for s in trace))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        m = step_lane_metrics(
            trace, llc=self.llc, dram=self.dram, mix=self.mix,
            warm_prefix=(trace if steady else None),
            chunk_bursts=self.chunk_bursts, t_llc_hit=self.t_llc_hit,
            device=self.device)
        out = StepLatency(cycles=m.total_cycles,
                          seconds=m.total_cycles / self.freq_hz, metrics=m)
        self._memo[key] = out
        return out

    def decode_step(self, kv: PagedKVCache, rids: list[int]) -> StepLatency:
        """Steady-state marginal cost of one decode step at the current
        slot occupancy."""
        return self._cost(self.decode_trace(kv, rids), steady=True)

    def prefill_step(self, kv: PagedKVCache, rids: list[int],
                     decode_rids: list[int] = ()) -> StepLatency:
        """Cold cost of admitting ``rids`` (prompt block fill).  When
        the engine runs prefill and decode in the same step
        (disaggregation), the decoding slots' reads join the trace so
        admission contends with in-flight requests."""
        streams = self.prefill_trace(kv, rids)
        if decode_rids:
            streams = streams + self.decode_trace(kv, list(decode_rids))
        return self._cost(streams, steady=False)

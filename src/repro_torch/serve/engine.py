"""Continuous-batching serving engine scheduled by simulated SoC latency.

* **continuous batching** — requests queue with arrival times and are
  admitted into per-request *slots* as capacity frees; one decode call
  (``models.slot_decode_step``) advances every active slot with an
  independent position per row, so sequences at different lengths batch
  without padding to a common step count;
* **paged KV cache** — a shared block pool with per-request block tables
  (``serve.kvcache``) governs admission and maps each request's KV to
  simulated DBB addresses; the model keeps shape-static per-slot cache
  rows on the device;
* **prefill/decode disaggregation** — one scheduler step admits new
  requests (batched prefill per prompt length fills their rows) while
  the decode call advances the already-active slots; both working sets
  share the step's DBB trace so admission contends with in-flight
  requests;
* **simulated clock** — every step's latency comes from the SoC memory
  pipeline (``serve.oracle`` -> ``sweep.step_lane_metrics``), so
  tokens/s and per-request p50/p99 are reported in simulated SoC time.

The model runs on ``device`` (``cuda`` unless the caller asks for
another), with the prefill's intra-chunk SSD step and its local
attention in Hopper kernels there.  Typed frozen ``Request`` / ``StepResult`` / ``EngineStats``
records with ``to_record()``/``from_record()`` are the journal currency.
``wall_s`` splits the host wall time of the run into the model
(prefill + decode, which end in a copy of the logits to the host) and
the oracle.  ``checkpoint``/``restore`` snapshot and resume every piece
of scheduler state bit for bit; the deprecated ``generate()`` shim runs
a padded static batch through the queue, as the reference's does.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
import warnings

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (
    cache_slot_axes,
    decode_working_set,
    init_caches,
    prefill,
    slot_decode_step,
)
from repro_torch.serve.kvcache import PagedKVCache
from repro_torch.serve.oracle import SoCLatencyOracle
from repro_torch.types import param_values, tree_map
from repro_torch.utils import prng
from repro_torch.utils.env import default_device
from repro_torch.utils.stats import nearest_rank


# --------------------------------------------------------------------------
# typed records
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: prompt tokens, a generation budget, and an
    offered-load arrival time (seconds, simulated clock)."""
    rid: int
    tokens: tuple[int, ...]
    max_new: int
    arrival_s: float = 0.0

    def __post_init__(self):
        if not self.tokens:
            raise ValueError("request needs at least one prompt token")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    def to_record(self) -> dict:
        return {"rid": self.rid, "tokens": list(self.tokens),
                "max_new": self.max_new, "arrival_s": self.arrival_s}

    @classmethod
    def from_record(cls, record: dict) -> "Request":
        return cls(rid=int(record["rid"]),
                   tokens=tuple(int(t) for t in record["tokens"]),
                   max_new=int(record["max_new"]),
                   arrival_s=float(record["arrival_s"]))


@dataclasses.dataclass(frozen=True)
class StepResult:
    """One scheduler step: what ran, what it emitted, and what the SoC
    pipeline charged for it."""
    step: int
    kind: str                       # "prefill" | "decode" | "mixed" | "idle"
    cycles: int
    sim_time_s: float               # clock *after* this step
    active: int                     # occupied slots during the step
    admitted: tuple[int, ...]       # rids admitted this step
    emitted: tuple[tuple[int, int], ...]   # (rid, token) pairs
    finished: tuple[int, ...]       # rids that completed this step
    llc_hit_rate: float | None = None      # None on idle steps

    _KINDS = ("prefill", "decode", "mixed", "idle")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown step kind {self.kind!r}")

    def to_record(self) -> dict:
        return {"step": self.step, "kind": self.kind, "cycles": self.cycles,
                "sim_time_s": self.sim_time_s, "active": self.active,
                "admitted": list(self.admitted),
                "emitted": [list(e) for e in self.emitted],
                "finished": list(self.finished),
                "llc_hit_rate": self.llc_hit_rate}

    @classmethod
    def from_record(cls, record: dict) -> "StepResult":
        hr = record["llc_hit_rate"]
        return cls(step=int(record["step"]), kind=str(record["kind"]),
                   cycles=int(record["cycles"]),
                   sim_time_s=float(record["sim_time_s"]),
                   active=int(record["active"]),
                   admitted=tuple(int(r) for r in record["admitted"]),
                   emitted=tuple((int(r), int(t))
                                 for r, t in record["emitted"]),
                   finished=tuple(int(r) for r in record["finished"]),
                   llc_hit_rate=None if hr is None else float(hr))


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """End-of-run serving summary, all times in simulated SoC seconds."""
    requests: int
    tokens: int
    steps: int
    prefill_steps: int
    decode_steps: int
    idle_steps: int
    sim_time_s: float
    tokens_per_s: float
    latency_p50_s: float
    latency_p99_s: float
    mean_occupancy: float
    max_occupancy: int

    _INT_FIELDS = ("requests", "tokens", "steps", "prefill_steps",
                   "decode_steps", "idle_steps", "max_occupancy")
    _FLOAT_FIELDS = ("sim_time_s", "tokens_per_s", "latency_p50_s",
                     "latency_p99_s", "mean_occupancy")

    def to_record(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, record: dict) -> "EngineStats":
        kw = {f: int(record[f]) for f in cls._INT_FIELDS}
        kw.update({f: float(record[f]) for f in cls._FLOAT_FIELDS})
        return cls(**kw)



@dataclasses.dataclass
class GenerationResult:
    """Result shape of the deprecated ``generate()`` shim (seed API)."""
    tokens: np.ndarray          # (B, steps) generated ids
    lengths: np.ndarray         # (B,) #tokens before EOS (or steps)
    steps: int


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Slot:
    rid: int
    t: int                       # absolute position of the next KV write
    last_token: int              # token the next decode consumes
    generated: list[int]
    max_new: int
    prompt_len: int
    arrival_s: float


class ServeEngine:
    """Continuous-batching engine over a model + simulated SoC.

    Constructor config is keyword-only: ``cache_len=`` (per-slot cache
    capacity; prompt + max_new must fit), ``block_size=`` (tokens per KV
    block), ``max_slots=`` (concurrent requests), ``oracle=`` (a
    ``SoCLatencyOracle``; default derives one from the model's decode
    working set), ``num_blocks=`` (pool size; default backs every slot
    at full cache_len), ``eos_id=``/``temperature=``/``seed=``, and
    ``device=`` (where the model runs and, for the default oracle, the
    LLC replay; ``cuda`` when None — ``params`` must live there).
    """

    def __init__(self, cfg: ModelConfig, params, *, cache_len: int,
                 block_size: int = 16, max_slots: int = 4,
                 oracle: SoCLatencyOracle | None = None,
                 num_blocks: int | None = None,
                 eos_id: int = 2, temperature: float = 0.0,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.device = default_device(device)
        self.cache_len = int(cache_len)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.eos_id = int(eos_id)
        self.temperature = float(temperature)
        self.seed = int(seed)
        ws = decode_working_set(cfg)
        self.oracle = oracle or SoCLatencyOracle(ws, device=self.device)
        if num_blocks is None:
            num_blocks = self.max_slots * -(-self.cache_len // self.block_size)
        self.kv = PagedKVCache(num_blocks=num_blocks,
                               block_size=self.block_size,
                               token_bytes=max(1, ws.kv_token_bytes))
        self._prefill = functools.partial(prefill, cfg=cfg,
                                          cache_len=self.cache_len)
        self._decode = functools.partial(slot_decode_step, cfg=cfg)
        self.queue: collections.deque = collections.deque()
        self._extras: dict[int, dict] = {}
        self.slots: list[_Slot | None] = [None] * self.max_slots
        self._caches = None          # lazy: materialized on first admission
        self._axes = None
        self.finished: list[dict] = []
        self.step_log: list[StepResult] = []
        self.clock_cycles = 0
        self.step_idx = 0
        self._counts = {"prefill": 0, "decode": 0, "mixed": 0, "idle": 0}
        self._occupancy_sum = 0
        self._occupancy_max = 0
        self.wall_s = {"model": 0.0, "oracle": 0.0}

    # -- submission --------------------------------------------------------
    @property
    def clock_s(self) -> float:
        return self.clock_cycles / self.oracle.freq_hz

    def submit(self, request: Request, *, extras: dict | None = None
               ) -> None:
        """Queue a request.  ``extras`` carries non-token prefill inputs
        (e.g. whisper ``frames``), kept on the host as numpy arrays —
        they are not part of the typed record."""
        total = len(request.tokens) + request.max_new
        if total > self.cache_len:
            raise ValueError(
                f"request {request.rid}: prompt {len(request.tokens)} + "
                f"max_new {request.max_new} exceeds cache_len "
                f"{self.cache_len}")
        if self.kv.blocks_for(total) > self.kv.num_blocks:
            raise ValueError(
                f"request {request.rid} needs "
                f"{self.kv.blocks_for(total)} KV blocks but the pool "
                f"only has {self.kv.num_blocks} — it could never be "
                "admitted")
        if any(r.rid == request.rid for r in self.queue) or any(
                s is not None and s.rid == request.rid for s in self.slots):
            raise ValueError(f"duplicate rid {request.rid}")
        self.queue.append(request)
        if extras:
            self._extras[request.rid] = {k: np.asarray(v)
                                         for k, v in extras.items()}

    # -- internals ---------------------------------------------------------
    def _materialize_caches(self) -> None:
        if self._caches is None:
            self._caches = param_values(init_caches(
                self.cfg, self.max_slots, self.cache_len,
                device=self.device))
            self._axes = cache_slot_axes(self._caches)

    def _request_key(self, rid: int, n: int) -> np.ndarray:
        """The reference's key of request ``rid``'s ``n``-th token:
        ``fold_in(fold_in(PRNGKey(seed), rid), n)``."""
        return prng.fold_in(prng.fold_in(prng.prng_key(self.seed), rid), n)

    def _sample_row(self, logits_row: np.ndarray, rid: int, n: int) -> int:
        row = logits_row[:self.cfg.vocab_size]
        if self.temperature == 0.0:
            return int(np.argmax(row))
        return prng.categorical(self._request_key(rid, n),
                                row.astype(np.float32)
                                / np.float32(self.temperature))

    def _free_slot_ids(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _active_slot_ids(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _admit(self) -> list[tuple[int, Request]]:
        """FIFO admission: arrival due, a free slot, and a full KV
        reservation available (head-of-line blocking by design — the
        trace replays deterministically)."""
        placed = []
        free = self._free_slot_ids()
        while (self.queue and free
               and self.queue[0].arrival_s <= self.clock_s
               and self.kv.can_admit(len(self.queue[0].tokens)
                                     + self.queue[0].max_new)):
            req = self.queue.popleft()
            slot_id = free.pop(0)
            self.kv.admit(req.rid, len(req.tokens), req.max_new)
            placed.append((slot_id, req))
        return placed

    def _run_prefill(self, placed: list[tuple[int, Request]]) -> list:
        """Batched prefill per same-length admission group; write the
        resulting rows into the slot caches in place (the engine owns
        them); sample each request's first token (it counts against
        max_new)."""
        self._materialize_caches()
        emitted = []
        groups: dict[int, list[tuple[int, Request]]] = {}
        for slot_id, req in placed:
            groups.setdefault(len(req.tokens), []).append((slot_id, req))
        for plen, group in sorted(groups.items()):
            batch = {"tokens": torch.as_tensor(
                [list(r.tokens) for _, r in group], dtype=torch.int64,
                device=self.device)}
            ex = [self._extras.get(r.rid) for _, r in group]
            if ex[0] is not None:
                for k in ex[0]:
                    batch[k] = torch.as_tensor(np.stack([e[k] for e in ex]),
                                               device=self.device)
            logits, new_caches, _ = self._prefill(self.params, batch)
            sids = torch.as_tensor([sid for sid, _ in group],
                                   device=self.device)
            tree_map(lambda f, n, ax: f.index_copy_(ax, sids, n.to(f.dtype)),
                     self._caches, new_caches, self._axes)
            logits_np = logits.cpu().numpy()
            for g, (slot_id, req) in enumerate(group):
                first = self._sample_row(logits_np[g], req.rid, 0)
                self.kv.append(req.rid)
                self.slots[slot_id] = _Slot(
                    rid=req.rid, t=plen, last_token=first, generated=[first],
                    max_new=req.max_new, prompt_len=plen,
                    arrival_s=req.arrival_s)
                emitted.append((req.rid, first))
        return emitted

    def _run_decode(self, slot_ids: list[int]) -> list:
        """One decode over the full slot batch; only the listed slots'
        rows are consumed (inactive rows compute garbage that the next
        prefill write overwrites)."""
        toks = np.zeros((self.max_slots, 1), np.int64)
        ts = np.zeros((self.max_slots,), np.int64)
        for i in slot_ids:
            s = self.slots[i]
            toks[i, 0] = s.last_token
            ts[i] = s.t
        logits, self._caches = self._decode(
            self.params, self._caches,
            torch.as_tensor(toks, device=self.device),
            torch.as_tensor(ts, device=self.device))
        logits_np = logits.cpu().numpy()
        emitted = []
        for i in slot_ids:
            s = self.slots[i]
            s.t += 1
            tok = self._sample_row(logits_np[i], s.rid, len(s.generated))
            s.generated.append(tok)
            s.last_token = tok
            self.kv.append(s.rid)
            emitted.append((s.rid, tok))
        return emitted

    def _retire(self) -> list[int]:
        done = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            if s.generated[-1] == self.eos_id or len(s.generated) >= s.max_new:
                finish_s = self.clock_s
                self.finished.append({
                    "rid": s.rid, "tokens": list(s.generated),
                    "arrival_s": s.arrival_s, "finish_s": finish_s,
                    "latency_s": finish_s - s.arrival_s})
                self.kv.release(s.rid)
                self._extras.pop(s.rid, None)
                self.slots[i] = None
                done.append(s.rid)
        return done

    # -- the scheduler step ------------------------------------------------
    def step(self) -> StepResult:
        """Advance the engine by one scheduler step.

        Admission (prefill) and decode of already-active slots share the
        step; the step's simulated latency is charged *before* outputs
        are processed, from the working set the step actually touches.
        With nothing active and nothing due, the clock fast-forwards to
        the next arrival (an idle step)."""
        if not self.queue and not self._active_slot_ids():
            raise RuntimeError("engine is drained: nothing queued or active")
        active_before = self._active_slot_ids()
        placed = self._admit()
        admitted_rids = [r.rid for _, r in placed]
        decode_rids = [self.slots[i].rid for i in active_before]

        t0 = time.perf_counter()
        if placed and decode_rids:
            kind = "mixed"
            lat = self.oracle.prefill_step(self.kv, admitted_rids,
                                           decode_rids=decode_rids)
        elif placed:
            kind = "prefill"
            lat = self.oracle.prefill_step(self.kv, admitted_rids)
        elif decode_rids:
            kind = "decode"
            lat = self.oracle.decode_step(self.kv, decode_rids)
        else:
            # idle: fast-forward to the next arrival
            kind = "idle"
            nxt = min(r.arrival_s for r in self.queue)
            target = max(0, int(np.ceil(nxt * self.oracle.freq_hz)))
            cycles = max(1, target - self.clock_cycles)
            self.clock_cycles += cycles
            self._counts["idle"] += 1
            self.step_idx += 1
            res = StepResult(step=self.step_idx - 1, kind=kind,
                             cycles=cycles, sim_time_s=self.clock_s,
                             active=0, admitted=(), emitted=(),
                             finished=())
            self.step_log.append(res)
            return res
        t1 = time.perf_counter()
        self.wall_s["oracle"] += t1 - t0

        # decode first: the decode call writes every inactive row too
        # (masking is host-side), and the prefill write must be what
        # lands last in a just-admitted slot's cache row.
        emitted = []
        if active_before:
            emitted.extend(self._run_decode(active_before))
        if placed:
            emitted.extend(self._run_prefill(placed))
        self.wall_s["model"] += time.perf_counter() - t1

        self.clock_cycles += lat.cycles
        occupancy = len(active_before) + len(placed)
        self._occupancy_sum += occupancy
        self._occupancy_max = max(self._occupancy_max, occupancy)
        finished = self._retire()
        self._counts[kind] += 1
        self.step_idx += 1
        res = StepResult(step=self.step_idx - 1, kind=kind,
                         cycles=lat.cycles, sim_time_s=self.clock_s,
                         active=occupancy, admitted=tuple(admitted_rids),
                         emitted=tuple(emitted), finished=tuple(finished),
                         llc_hit_rate=lat.metrics.hit_rate)
        self.step_log.append(res)
        return res

    def run(self, *, max_steps: int | None = None) -> EngineStats:
        """Run until the queue and every slot drain (or max_steps)."""
        n = 0
        while self.queue or self._active_slot_ids():
            if max_steps is not None and n >= max_steps:
                break
            self.step()
            n += 1
        return self.stats()

    def stats(self) -> EngineStats:
        lat = sorted(f["latency_s"] for f in self.finished)
        tokens = sum(len(f["tokens"]) for f in self.finished)
        busy = sum(v for k, v in self._counts.items() if k != "idle")
        t = self.clock_s
        return EngineStats(
            requests=len(self.finished), tokens=tokens,
            steps=self.step_idx,
            prefill_steps=self._counts["prefill"] + self._counts["mixed"],
            decode_steps=self._counts["decode"] + self._counts["mixed"],
            idle_steps=self._counts["idle"],
            sim_time_s=t,
            tokens_per_s=tokens / t if t > 0 else 0.0,
            latency_p50_s=nearest_rank(lat, 50),
            latency_p99_s=nearest_rank(lat, 99),
            mean_occupancy=self._occupancy_sum / max(1, busy),
            max_occupancy=self._occupancy_max)

    # -- checkpoint / restore ---------------------------------------------
    def _fingerprint(self) -> tuple:
        return (self.cache_len, self.block_size, self.max_slots,
                self.eos_id, self.temperature, self.seed)

    def checkpoint(self) -> dict:
        """Host-side snapshot of every piece of scheduler state.  The
        caches are kept as host tensors (``.cpu().clone()``, dtypes as
        they are: numpy has no bf16, where the reference keeps numpy
        arrays; ``to("cpu", copy=True)``).  Restoring into a fresh engine with the same config and
        params resumes bit-identically."""
        caches = (None if self._caches is None else
                  tree_map(lambda t: t.to("cpu", copy=True), self._caches))
        return {
            "fingerprint": self._fingerprint(),
            "clock_cycles": self.clock_cycles,
            "step_idx": self.step_idx,
            "counts": dict(self._counts),
            "occupancy_sum": self._occupancy_sum,
            "occupancy_max": self._occupancy_max,
            "queue": [r.to_record() for r in self.queue],
            "extras": {rid: {k: v.copy() for k, v in ex.items()}
                       for rid, ex in self._extras.items()},
            "slots": [None if s is None else dataclasses.asdict(s)
                      for s in self.slots],
            "kv": self.kv.snapshot(),
            "caches": caches,
            "finished": [dict(f) for f in self.finished],
        }

    def restore(self, snap: dict) -> None:
        """Resume from ``checkpoint()``'s snapshot (which stays
        unchanged: the caches are copied onto the engine's device)."""
        if tuple(snap["fingerprint"]) != self._fingerprint():
            raise ValueError(
                f"checkpoint fingerprint {snap['fingerprint']} does not "
                f"match engine config {self._fingerprint()}")
        self.clock_cycles = int(snap["clock_cycles"])
        self.step_idx = int(snap["step_idx"])
        self._counts = dict(snap["counts"])
        self._occupancy_sum = int(snap["occupancy_sum"])
        self._occupancy_max = int(snap["occupancy_max"])
        self.queue = collections.deque(
            Request.from_record(r) for r in snap["queue"])
        self._extras = {int(rid): {k: np.asarray(v) for k, v in ex.items()}
                        for rid, ex in snap["extras"].items()}
        self.slots = [None if s is None else
                      _Slot(**{**s, "generated": list(s["generated"])})
                      for s in snap["slots"]]
        self.kv.restore(snap["kv"])
        if snap["caches"] is None:
            self._caches = None
            self._axes = None
        else:
            self._caches = tree_map(
                lambda t: t.to(self.device, copy=True), snap["caches"])
            self._axes = cache_slot_axes(self._caches)
        self.finished = [dict(f) for f in snap["finished"]]
        self.step_log = []

    # -- deprecated seed API ----------------------------------------------
    def generate(self, batch: dict, max_new: int, *, seed: int = 0
                 ) -> GenerationResult:
        """Seed-era padded static-batch generation.

        .. deprecated:: round-trips through the continuous-batching
           queue; greedy tokens equal the seed loop's (per-row argmax
           decode is batch-size invariant).  Use ``submit()`` + ``run()``
           and the typed records instead.
        """
        warnings.warn(
            "ServeEngine.generate(batch, max_new) is deprecated; submit "
            "typed Requests and run() the continuous-batching scheduler",
            DeprecationWarning, stacklevel=2)
        if self.queue or self._active_slot_ids():
            raise RuntimeError("generate() shim requires a drained engine")
        toks = np.asarray(batch["tokens"])
        b = toks.shape[0]
        extras = {k: np.asarray(v) for k, v in batch.items()
                  if k != "tokens"}
        base = 1 + max((f["rid"] for f in self.finished), default=-1)
        rids = list(range(base, base + b))
        for i, rid in enumerate(rids):
            self.submit(Request(rid=rid, tokens=tuple(int(t)
                                                      for t in toks[i]),
                                max_new=max_new, arrival_s=self.clock_s),
                        extras={k: v[i] for k, v in extras.items()} or None)
        self.run()
        by_rid = {f["rid"]: f["tokens"] for f in self.finished}
        rows = [by_rid[rid] for rid in rids]
        n_cols = max(len(r) for r in rows)
        out = np.full((b, n_cols), self.eos_id, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        lengths = np.argmax(out == self.eos_id, axis=1)
        lengths = np.where((out == self.eos_id).any(axis=1), lengths,
                           n_cols)
        return GenerationResult(tokens=out, lengths=lengths, steps=n_cols)

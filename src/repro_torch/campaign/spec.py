"""Declarative sweep-campaign specs with content-addressed points.

A campaign is the cross product

    models x LLC geometries x co-runner mixes x DRAM configs

expanded into a *deterministic* list of ``CampaignPoint``s: same spec,
same point list, same order, and every point carries a stable
``point_id`` — a content hash of exactly the parameters that determine
its result (never wall-clock, host names, or execution order).  The
executor (``repro_torch.campaign.executor``) journals completed points
by id, so a resumed campaign can decide what is already done without
trusting anything but the spec and the journal; a spec edit that
changes any point's physics changes that point's id and forces a
re-run.

Specs round-trip through JSON (``CampaignSpec.to_dict``/``from_dict``)
so campaign files can live in the repo and in CI.  Every ``point_id``
and ``spec_hash`` equals the reference package's for the same spec, so
a journal written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json

from repro_torch.core.cache import LLCConfig
from repro_torch.core.dram import DRAMConfig

SPEC_VERSION = 1

_WSS_CHOICES = ("l1", "llc", "dram")


_BACKENDS = ("nvdla", "npu")
# trace sources per backend: NVDLA replays the fixed-function conv
# pipeline's YOLOv3 streams; the NPU backend compiles any model-zoo
# GEMM workload (repro_torch.core.npu.WORKLOADS)
_BACKEND_MODELS = {
    "nvdla": ("yolov3",),
    "npu": ("yolov3", "transformer_decode", "mamba2_decode",
            "whisper_encoder"),
}


@functools.lru_cache(maxsize=8)
def _model_trace(window_bursts, chunk_bursts, layer_index):
    from repro_torch.core import traces

    if window_bursts is None:
        return traces.network_trace()
    return traces.default_dbb_window(max_bursts=window_bursts,
                                     chunk_bursts=chunk_bursts,
                                     layer_index=layer_index)


@functools.lru_cache(maxsize=8)
def _npu_trace(name, window_bursts, chunk_bursts, rows, cols):
    from repro_torch.core import npu

    cfg = npu.NPUConfig(rows=rows, cols=cols)
    return npu.npu_chunks(npu.workload(name), cfg, chunk_bursts,
                          max_bursts=window_bursts)


def canonical_json(obj) -> str:
    """The one JSON encoding used for hashing and checksums: sorted
    keys, no whitespace — byte-stable across processes and runs."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def content_hash(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One DBB trace source on one accelerator backend.

    ``backend="nvdla"`` (the default) replays the fixed-function conv
    pipeline's YOLOv3 streams: ``window_bursts=None`` replays the whole
    network trace, an integer clips an arbiter-interleaved window of
    ``layer_index``'s streams (see ``repro_torch.core.traces``).
    ``backend="npu"`` compiles the named model-zoo GEMM workload on a
    ``npu_rows x npu_cols`` weight-stationary systolic array
    (``repro_torch.core.npu``) and windows its interleaved DBB stream the
    same way — both backends are just segment sources to the campaign.

    Axis fields hash only where they carry physics: the backend fields
    are dropped from ``to_dict`` at their NVDLA defaults (so every
    pre-backend ``point_id`` is unchanged) and ``layer_index`` is
    dropped for NPU points (the NPU has no NVDLA layer windows); to
    keep the hash faithful, a field that would be dropped must sit at
    its default — validated below."""
    name: str = "yolov3"
    window_bursts: int | None = 4096
    chunk_bursts: int = 16
    layer_index: int = 40
    backend: str = "nvdla"
    npu_rows: int = 16
    npu_cols: int = 16

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; campaign "
                             f"backends are: {_BACKENDS}")
        known = _BACKEND_MODELS[self.backend]
        if self.name not in known:
            raise ValueError(f"unknown model {self.name!r}; the "
                             f"{self.backend!r} trace sources are: {known}")
        if self.window_bursts is not None and self.window_bursts <= 0:
            raise ValueError("window_bursts must be positive or None "
                             f"(whole frame), got {self.window_bursts}")
        if self.backend == "nvdla":
            if (self.npu_rows, self.npu_cols) != (16, 16):
                raise ValueError(
                    "npu_rows/npu_cols only apply to backend='npu' "
                    "(they are excluded from NVDLA point hashes, so a "
                    "non-default value would be silently ignored)")
        else:
            if self.npu_rows <= 0 or self.npu_cols <= 0:
                raise ValueError(f"NPU grid must be positive, got "
                                 f"{self.npu_rows}x{self.npu_cols}")
            if self.layer_index != 40:
                raise ValueError(
                    "layer_index only applies to backend='nvdla' (it is "
                    "excluded from NPU point hashes, so a non-default "
                    "value would be silently ignored)")

    def trace(self):
        # memoized: the window is a pure function of the (frozen) spec,
        # and the executor asks for it once per lane shard — callers
        # must treat the returned segment list as read-only
        if self.backend == "npu":
            return _npu_trace(self.name, self.window_bursts,
                              self.chunk_bursts, self.npu_rows,
                              self.npu_cols)
        return _model_trace(self.window_bursts, self.chunk_bursts,
                            self.layer_index)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.backend == "nvdla":
            # pre-backend hash compatibility: NVDLA dicts are exactly
            # what they were before the backend axis existed
            del d["backend"], d["npu_rows"], d["npu_cols"]
        else:
            del d["layer_index"]
        return d


@dataclasses.dataclass(frozen=True)
class GeometrySpec:
    """LLC geometry.  ``ways=None`` applies the Fig. 5 grid rule
    (``repro_torch.core.soc.llc_config_for``); an explicit ``ways`` pins the
    associativity, which also lets campaigns build constant-``sets``
    families where LRU inclusion makes hit counts provably monotone in
    ways (the executor's cross-point guardrail)."""
    size_kib: float
    block: int = 64
    ways: int | None = None

    def __post_init__(self):
        if self.size_kib <= 0 or self.block <= 0:
            raise ValueError(f"geometry must be positive, got "
                             f"size_kib={self.size_kib} block={self.block}")
        if self.ways is not None and self.ways <= 0:
            raise ValueError(f"ways must be positive, got {self.ways}")

    def llc(self) -> LLCConfig:
        if self.ways is None:
            from repro_torch.core.soc import llc_config_for

            return llc_config_for(self.size_kib, self.block)
        return LLCConfig(size_bytes=int(self.size_kib * 1024),
                         ways=self.ways, block_bytes=self.block)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class MixSpec:
    """Co-runner mix: ``corunners`` BwWrite streams with working-set
    size class ``wss`` interleaved into the lane (Fig. 6 semantics)."""
    corunners: int = 0
    wss: str = "l1"

    def __post_init__(self):
        if self.corunners < 0:
            raise ValueError(f"corunners must be >= 0, got {self.corunners}")
        if self.wss not in _WSS_CHOICES:
            raise ValueError(f"wss must be one of {_WSS_CHOICES}, "
                             f"got {self.wss!r}")

    def mix(self):
        """The core-engine ``repro_torch.core.sweep.MixConfig`` this spec
        describes (the same late-bound pattern as ``GeometrySpec.llc``)."""
        from repro_torch.core.sweep import MixConfig

        return MixConfig(corunners=self.corunners, wss=self.wss)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DRAMSpec:
    banks: int = 32
    row_bytes: int = 2048
    t_cas_cycles: int = 14
    t_rcd_cycles: int = 14
    t_rp_cycles: int = 14

    def __post_init__(self):
        if self.banks <= 0 or self.row_bytes <= 0:
            raise ValueError(f"DRAM geometry must be positive, got "
                             f"banks={self.banks} row_bytes={self.row_bytes}")

    def dram(self) -> DRAMConfig:
        return DRAMConfig(banks=self.banks, row_bytes=self.row_bytes,
                          t_cas_cycles=self.t_cas_cycles,
                          t_rcd_cycles=self.t_rcd_cycles,
                          t_rp_cycles=self.t_rp_cycles)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class CampaignPoint:
    """One (model, geometry, mix, dram) simulation.  ``point_id`` hashes
    the physics-determining parameters plus ``SPEC_VERSION`` so result
    records are self-describing and spec edits invalidate exactly the
    points they change."""
    model: ModelSpec
    geometry: GeometrySpec
    mix: MixSpec
    dram: DRAMSpec

    def params(self) -> dict:
        return {"spec_version": SPEC_VERSION,
                "model": self.model.to_dict(),
                "geometry": self.geometry.to_dict(),
                "mix": self.mix.to_dict(),
                "dram": self.dram.to_dict()}

    @property
    def point_id(self) -> str:
        return content_hash(self.params())


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    name: str
    models: tuple[ModelSpec, ...] = (ModelSpec(),)
    geometries: tuple[GeometrySpec, ...] = (GeometrySpec(2048),)
    mixes: tuple[MixSpec, ...] = (MixSpec(),)
    drams: tuple[DRAMSpec, ...] = (DRAMSpec(),)

    def __post_init__(self):
        if not (self.models and self.geometries and self.mixes
                and self.drams):
            raise ValueError("a campaign needs at least one model, "
                             "geometry, mix, and DRAM config")
        for d in self.drams:
            for g in self.geometries:
                if d.row_bytes % g.block:
                    raise ValueError(
                        f"DRAM row_bytes {d.row_bytes} is not a multiple "
                        f"of LLC block {g.block}: the segment-native "
                        "pipeline needs whole blocks per row (see "
                        "socsim.simulate_dbb_segments)")

    def expand(self) -> list[CampaignPoint]:
        """The deterministic point list: models (outer) x drams x mixes
        x geometries (inner), exactly the spec's declared order."""
        return [CampaignPoint(m, g, x, d)
                for m in self.models for d in self.drams
                for x in self.mixes for g in self.geometries]

    @property
    def spec_hash(self) -> str:
        return content_hash(self.to_dict())

    def to_dict(self) -> dict:
        return {"spec_version": SPEC_VERSION, "name": self.name,
                "models": [m.to_dict() for m in self.models],
                "geometries": [g.to_dict() for g in self.geometries],
                "mixes": [x.to_dict() for x in self.mixes],
                "drams": [d.to_dict() for d in self.drams]}

    @classmethod
    def from_dict(cls, d: dict) -> "CampaignSpec":
        version = d.get("spec_version", SPEC_VERSION)
        if version != SPEC_VERSION:
            raise ValueError(f"campaign spec version {version} is not "
                             f"supported (this build speaks {SPEC_VERSION})")
        return cls(
            name=d["name"],
            models=tuple(ModelSpec(**m) for m in d.get(
                "models", [{}])) or (ModelSpec(),),
            geometries=tuple(GeometrySpec(**g)
                             for g in d["geometries"]),
            mixes=tuple(MixSpec(**x) for x in d.get("mixes", [{}])),
            drams=tuple(DRAMSpec(**x) for x in d.get("drams", [{}])))

    @classmethod
    def load(cls, path: str) -> "CampaignSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


def example_spec(points: int = 8, *, window_bursts: int = 512,
                 name: str = "example") -> CampaignSpec:
    """A tiny but real campaign for smoke tests and CI: one windowed
    YOLOv3 trace, a same-``sets`` geometry family (so the monotone-ways
    guardrail is live), and solo + contended mixes, sized to exactly
    ``points`` points."""
    if not 0 < points <= 16:
        raise ValueError(f"example spec supports 1..16 points, got {points}")
    n_mixes = 2 if points % 2 == 0 and points >= 4 else 1
    n_geoms = points // n_mixes
    sets = 64
    geoms = tuple(GeometrySpec(size_kib=sets * (1 << i) * 64 / 1024,
                               block=64, ways=1 << i)
                  for i in range(n_geoms))
    mixes = (MixSpec(0, "l1"), MixSpec(2, "llc"))[:n_mixes]
    return CampaignSpec(
        name=name,
        models=(ModelSpec(window_bursts=window_bursts),),
        geometries=geoms, mixes=mixes)


def mixed_backend_spec(points: int = 8, *, window_bursts: int = 512,
                       name: str = "mixed-backends") -> CampaignSpec:
    """An NVDLA + NPU head-to-head campaign for smoke tests and CI:
    the same windowed YOLOv3 frame traced by both backends across a
    same-``sets`` geometry family, so every guardrail (including
    monotone-ways, which groups by model) runs per backend."""
    if points % 2 or not 0 < points <= 16:
        raise ValueError(f"mixed spec needs an even 2..16 points, "
                         f"got {points}")
    sets = 64
    geoms = tuple(GeometrySpec(size_kib=sets * (1 << i) * 64 / 1024,
                               block=64, ways=1 << i)
                  for i in range(points // 2))
    return CampaignSpec(
        name=name,
        models=(ModelSpec(window_bursts=window_bursts),
                ModelSpec(window_bursts=window_bursts, backend="npu",
                          npu_rows=8, npu_cols=8)),
        geometries=geoms)

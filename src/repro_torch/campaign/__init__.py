"""Fault-tolerant sweep-campaign orchestration — the PyTorch port of the
reference's campaign run farm (its design: docs/campaigns.md).

``CampaignSpec`` expands (models x geometries x mixes x DRAM configs)
into content-hashed points; ``run_campaign`` executes them with
journaled manifests, resume, retry/timeout, and numeric guardrails —
sequentially, or as lane-batched point batches on ``device`` (``cuda``
unless asked otherwise), optionally sharded over a device mesh
(``mesh=``/``batch_points=``); results are typed ``LaneMetrics``
records; ``FaultInjector`` injects deterministic crashes/hangs/NaNs/
torn writes so tests can prove the whole thing actually survives them.
Point ids, spec hashes, journals and manifests are byte-identical to
the reference package's.
"""
from repro_torch.campaign.executor import (
    CampaignResult,
    GuardrailViolation,
    PointHooks,
    PointTimeout,
    RetryPolicy,
    run_batch,
    run_campaign,
    run_point,
    shard_points,
    validate_result,
)
from repro_torch.campaign.faults import (
    Fault,
    FaultInjector,
    InjectedCrash,
    plan_from_indices,
)
from repro_torch.campaign.manifest import (
    Journal,
    JournalError,
    atomic_write_json,
    build_manifest,
)
from repro_torch.campaign.spec import (
    CampaignPoint,
    CampaignSpec,
    DRAMSpec,
    GeometrySpec,
    MixSpec,
    ModelSpec,
    example_spec,
    mixed_backend_spec,
)
from repro_torch.core.sweep import LaneMetrics, MixConfig, SweepGrid

"""Serving: continuous batching scheduled by simulated SoC latencies."""
from repro_torch.serve.engine import (  # noqa: F401
    EngineStats,
    Request,
    ServeEngine,
    StepResult,
)
from repro_torch.serve.kvcache import (  # noqa: F401
    BlockTable,
    OutOfBlocksError,
    PagedKVCache,
)
from repro_torch.serve.oracle import SoCLatencyOracle, StepLatency  # noqa: F401

"""Tuned performance presets (the reference's ``repro.launch.presets``).

Each entry is the *beyond-paper-baseline* configuration for a cell:
config-field overrides + sharding-rule overrides + microbatching.  The
paper-faithful baseline is always the no-preset run; ``dryrun --perf``
applies these on top so both are reproducible.  The entries are the
reference's; the reasons beside them are its reasons, and any figure of
the port's comes from the port's own dry-run.
"""
from __future__ import annotations

PERF_PRESETS: dict = {
    # worst roofline fraction: 14 heads can't TP-shard on a 16-way axis ->
    # sequence parallelism + single-chunk attention + no-remat w/ 2
    # microbatches.
    ("qwen2-0.5b", "train_4k"): {
        "overrides": {"attn_q_chunk": 4096, "remat": "none"},
        "rule_overrides": {"act_seq": ("model",)},
        "microbatches": 2,
    },
    # most collective-bound: TP of a 130M SSM is pure overhead -> 256-way
    # pure DP (batch over pod+data+model), SSM internals replicated.
    ("mamba2-130m", "train_4k"): {
        "overrides": {},
        "rule_overrides": {
            "act_batch": ("pod", "data", "model"),
            "ssm_inner": (), "ssm_heads": (),
            "act_ssm_inner": (), "act_heads": (),
        },
        "microbatches": 1,
    },
    # paper-representative serving cell: kv=8 can't shard 16-way ->
    # sequence-sharded KV cache + explicit split-K decode attention +
    # int8 KV quantization.
    ("grok-1-314b", "decode_32k"): {
        "overrides": {"kv_cache_dtype": "int8"},
        "rule_overrides": {"cache_seq": ("model",)},
        "microbatches": 1,
    },
}


def preset_for(arch: str, shape: str) -> dict | None:
    return PERF_PRESETS.get((arch, shape))

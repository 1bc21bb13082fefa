"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427; unverified] 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256_000,
        block_pattern=("rec", "rec", "attn"),
        local_window=2048,
        rglru_width=4096,
        act="gelu",
        gated_mlp=True,
        rope_fraction=0.5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        num_layers=4,  # one full [rec, rec, attn] group + 1 remainder rec
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=("rec", "rec", "attn"),
        local_window=16,
        rglru_width=64,
        act="gelu",
        gated_mlp=True,
        rope_fraction=0.5,
    )

"""granite-3-8b — dense GQA transformer.

[hf:ibm-granite/granite-3.0-2b-base; hf] 40L d_model=4096 32H (GQA kv=8)
d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49_155,
        act="silu",
        gated_mlp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=259,  # deliberately non-divisible -> exercises vocab padding
        act="silu",
        gated_mlp=True,
    )

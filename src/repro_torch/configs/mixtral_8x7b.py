"""mixtral-8x7b — sparse MoE transformer, 8 experts top-2, sliding-window attn.

[arXiv:2401.04088; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
SWA window 4096 makes long_500k decode feasible via a rolling KV buffer.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32_000,
        num_experts=8,
        num_experts_per_tok=2,
        sliding_window=4096,
        act="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        sliding_window=16,
        act="silu",
        gated_mlp=True,
    )

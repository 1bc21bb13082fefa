"""deepseek-7b — llama-architecture dense transformer (full MHA, kv=32).

[arXiv:2401.02954; hf] 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b",
        family="dense",
        num_layers=30,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=11008,
        vocab_size=102_400,
        act="silu",
        gated_mlp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        act="silu",
        gated_mlp=True,
    )

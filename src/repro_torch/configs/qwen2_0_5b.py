"""qwen2-0.5b — dense GQA transformer with QKV bias and tied embeddings.

[arXiv:2407.10671; hf] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_936,
        attn_bias=True,
        tie_embeddings=True,
        act="silu",
        gated_mlp=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,  # keeps the 7:1 q:kv flavour via kv=2 group=2
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_bias=True,
        tie_embeddings=True,
        act="silu",
        gated_mlp=True,
    )

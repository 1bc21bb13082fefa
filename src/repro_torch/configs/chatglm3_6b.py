"""chatglm3-6b — dense GQA transformer with 2d (half-dim) RoPE.

[arXiv:2406.12793; hf] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary embedding to half of each head's dims.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        head_dim=128,
        d_ff=13696,
        vocab_size=65_024,
        rope_fraction=0.5,
        attn_bias=True,  # chatglm uses qkv bias ("add_qkv_bias")
        act="silu",
        gated_mlp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_fraction=0.5,
        attn_bias=True,
        act="silu",
        gated_mlp=True,
    )

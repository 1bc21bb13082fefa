"""whisper-tiny — encoder-decoder audio transformer (backbone only).

[arXiv:2212.04356; unverified] 4L d_model=384 6H d_ff=1536 vocab=51865.
The conv frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings of shape (batch, encoder_len, d_model).
Whisper uses pre-LN LayerNorm, GELU MLPs (not gated) and learned positions
(no RoPE) — rope_fraction=0 turns rotary off.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        num_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        is_encoder_decoder=True,
        num_encoder_layers=4,
        encoder_len=1500,
        rope_fraction=0.0,
        act="gelu",
        gated_mlp=False,
        use_layer_norm=True,
        attn_bias=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke",
        family="encdec",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        is_encoder_decoder=True,
        num_encoder_layers=2,
        encoder_len=32,
        rope_fraction=0.0,
        act="gelu",
        gated_mlp=False,
        use_layer_norm=True,
        attn_bias=True,
    )

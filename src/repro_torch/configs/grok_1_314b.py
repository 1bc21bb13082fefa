"""grok-1-314b — large sparse MoE transformer, 8 experts top-2.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072.  Grok-1 uses attention-logit tanh soft-capping (30.0).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131_072,
        num_experts=8,
        num_experts_per_tok=2,
        attn_logit_softcap=30.0,
        act="gelu",
        gated_mlp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
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
        attn_logit_softcap=30.0,
        act="gelu",
        gated_mlp=True,
    )

"""mamba2-130m — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060; unverified] 24L d_model=768 d_ff=0 vocab=50280,
ssm_state=128.  Mamba-2 blocks replace both attention and MLP; the block is
`in_proj -> conv1d -> SSD -> gated out_proj` with expand=2, head_dim=64.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        ssm_ngroups=1,
        block_pattern=("ssm",),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=32,
        ssm_chunk=32,
        ssm_ngroups=1,
        block_pattern=("ssm",),
        tie_embeddings=True,
    )

"""internvl2-26b — VLM: InternViT frontend (stub) + InternLM2-20B backbone.

[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Per the assignment the vision frontend is a STUB: ``input_specs`` supplies
precomputed patch embeddings (batch, num_patches, d_model) that are prepended
to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92_553,
        num_patches=256,
        act="silu",
        gated_mlp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_patches=8,
        act="silu",
        gated_mlp=True,
    )

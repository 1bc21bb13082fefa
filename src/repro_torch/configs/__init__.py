"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

``ARCHS`` lists the architectures the port runs: the SSM family
(``mamba2-130m``), the Griffin hybrid of RG-LRU and local attention
(``recurrentgemma-9b``), the dense transformer family with
full-context attention (``qwen2-0.5b``, ``deepseek-7b``,
``granite-3-8b``, ``chatglm3-6b``), the top-k MoE family
(``mixtral-8x7b`` with sliding-window attention, ``grok-1-314b`` with
soft-capped attention), the encoder-decoder ``whisper-tiny`` and the
VLM ``internvl2-26b`` (precomputed patch embeddings put before the
tokens) — all ten of the reference's archs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    pad_to,
    shape_applicable,
)

_ARCH_MODULES = {
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).config()


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).smoke_config()

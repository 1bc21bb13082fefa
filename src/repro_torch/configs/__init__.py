"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

Lists the architectures whose block kinds the port runs — so far the
SSM family (``mamba2-130m``).  The other archs of the reference's
registry arrive with their block kinds (ROADMAP, port queue).
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

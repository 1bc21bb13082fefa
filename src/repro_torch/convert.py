"""Carry state from the reference package into the port.

The port imports nothing of the reference, so this is duck-typed: the
numeric stage's parameters arrive as numpy arrays (or anything
``np.asarray`` takes) and configs as any objects with the same
dataclass fields as the port's.  Tests use it to feed both packages the
same state: the numeric stage's tensors and configs (``stage_layers``,
``to_config``) and a model's parameter and decode-cache trees
(``model_tree``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.accelerator import AccelConfig, MemSystemConfig
from repro_torch.core.cache import LLCConfig
from repro_torch.core.dram import DRAMConfig
from repro_torch.core.soc import CpuConfig, SoCConfig
from repro_torch.types import tree_map
from repro_torch.utils.env import default_device

CONFIGS = {c.__name__: c for c in (SoCConfig, LLCConfig, DRAMConfig,
                                   AccelConfig, MemSystemConfig, CpuConfig)}

# per-layer tensors of the numeric stage: int8 HWIO weights, their
# per-output-channel scales, the SDP bias
STAGE_TENSORS = {"w": np.int8, "w_scale": np.float32, "bias": np.float32}


def stage_layers(params, *, device=None) -> list[dict]:
    """Numeric-stage layers (dicts holding ``w``, ``w_scale``, ``bias``
    and the conv's ``stride``/``padding``) -> the same dicts with the
    arrays as tensors on ``device`` (``cuda`` when None).  Arrays must
    already have their stage dtype; nothing is cast silently."""
    dev = default_device(device)
    layers = []
    for p in params:
        layer = dict(p)
        for key, dtype in STAGE_TENSORS.items():
            arr = np.asarray(p[key])
            if arr.dtype != dtype:
                raise TypeError(f"stage tensor {key!r} must be "
                                f"{np.dtype(dtype)}, got {arr.dtype}")
            layer[key] = torch.from_numpy(np.array(arr)).to(dev)
        layers.append(layer)
    return layers


def to_config(obj, cls=None):
    """Rebuild ``obj`` — any object with the dataclass fields of one of
    the port's configs — as that port config, field by field and
    recursively (a nested config becomes the port class of its type's
    name; ``None``, as a ``MemSystemConfig.llc``, stays ``None``)."""
    if cls is None:
        name = type(obj).__name__
        if name not in CONFIGS:
            raise TypeError(f"no port config named {name!r}; one of "
                            f"{sorted(CONFIGS)}")
        cls = CONFIGS[name]
    fields = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = to_config(value)
        fields[f.name] = value
    return cls(**fields)


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via fp32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def model_tree(tree, *, device=None):
    """A reference model tree with array leaves — the values of
    ``repro.models.init_params`` (``param_values``), or the decode
    caches of ``prefill``/``init_caches`` — as the port's tree of
    tensors on ``device`` (``cuda`` when None).

    The port keeps the reference's layout (dicts and tuples; the
    ``blocks`` leaves stacked on a leading layer axis), so the tree
    converts leaf for leaf; dtypes are kept (fp32 parameters and SSM
    states, bf16 conv tails)."""
    dev = default_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree)

"""PyTorch/CUDA port of the NVDLA/RISC-V SoC reproduction.

Mirrors ``repro`` module for module on the case study's path
(``repro_torch.core``) and runs the NVDLA numeric stage through
hand-written Hopper kernels (``repro_torch.kernels``).  Entry points run
on ``cuda`` unless the caller passes another ``device``.
"""
from repro_torch.utils.env import default_device  # noqa: F401

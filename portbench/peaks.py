"""The yardstick's peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates without sparsity, at the full 700 W limit).

A copy of the constants in ``repro_torch/launch/mesh.py`` (and of the
TF32 rate beside them in the data sheet), kept here so that a change
to the program cannot move the benchmark's rooflines.
"""
BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12      # tf32 tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take for ``flops`` operations at
    ``peak_flops`` and ``nbytes`` moved at the HBM rate: the larger of
    the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)

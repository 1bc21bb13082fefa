from repro_torch.kernels.swa.ops import swa_attention  # noqa: F401

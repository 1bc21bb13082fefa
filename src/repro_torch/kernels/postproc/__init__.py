from repro_torch.kernels.postproc.ops import postprocess  # noqa: F401

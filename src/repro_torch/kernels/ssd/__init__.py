from repro_torch.kernels.ssd.ops import ssd_intra_chunk  # noqa: F401

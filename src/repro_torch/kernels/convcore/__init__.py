from repro_torch.kernels.convcore.ops import conv2d_int8, matmul_int8  # noqa: F401

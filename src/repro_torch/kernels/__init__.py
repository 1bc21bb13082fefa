"""Hand-written Hopper kernels of the port, one package per TPU kernel
they replace: ``convcore`` (int8 GEMM + fused SDP epilogue) and
``postproc`` (fused SDP + PDP).  Each keeps the reference's
``kernel.py`` (launch) / ``ops.py`` (public op) / ``ref.py`` (plain
PyTorch version) split; the CUDA sources live in ``repro_torch/csrc``.
"""

"""Hand-written Hopper kernels of the port, one package per TPU kernel
they replace: ``convcore`` (int8 GEMM + fused SDP epilogue),
``postproc`` (fused SDP + PDP), ``ssd`` (the Mamba-2 intra-chunk step)
and ``swa`` (sliding-window flash attention); and ``llc``, the LLC
replay engines' device loops, which the reference ran as jitted scans
rather than Pallas kernels.  Each keeps the reference's
``kernel.py`` (launch) / ``ops.py`` (public op) / ``ref.py`` (plain
PyTorch version) split; the CUDA sources live in ``repro_torch/csrc``.
"""

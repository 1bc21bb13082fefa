"""The LLC replay engines: the per-set round walk of one geometry
(``set_walk``, behind ``core.cache.simulate_segments``) and the
segment-lane scan of many (``lane_scan``, behind
``core.cache.segment_lane_scan``), as hand-written CUDA kernels
(``csrc/llc.cu``) with their plain PyTorch versions (``ref.py``)."""
from repro_torch.kernels.llc.ops import lane_scan, set_walk  # noqa: F401

"""The LLC replay engines: the per-set round walk of one geometry
(``set_walk``, behind ``core.cache.simulate_segments``) and the
segment-lane scan of many (``lane_scan``, and ``lane_scan_many`` for
several lane batches in one launch, behind
``core.cache.segment_lane_scan_many``), as hand-written CUDA kernels
(``csrc/llc.cu``) with their plain PyTorch versions (``ref.py``)."""
from repro_torch.kernels.llc.ops import (  # noqa: F401
    lane_scan,
    lane_scan_many,
    set_walk,
)

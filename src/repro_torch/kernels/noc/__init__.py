"""The NoC switch's whole cycle loop (``switch``, behind
``core.noc.NoCSwitch.simulate``) as a hand-written CUDA kernel
(``csrc/noc.cu``), with its plain PyTorch version (``ref.py``)."""
from repro_torch.kernels.noc.ops import SwitchRun, switch  # noqa: F401

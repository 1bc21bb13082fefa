"""Device choice and address tensors.

* ``default_device`` — the port runs on the GPU: ``cuda`` unless the
  caller asks for another device, and an error (never a silent CPU run)
  when CUDA is asked for and absent;
* ``as_address_tensor`` — DBB byte addresses as int64 tensors, range
  -checked against the ``DRAM_ADDR_BITS``-bit physical address space so
  a generator bug cannot pass as a bigger DRAM;
* ``check_device_memory`` — a kernel wrapper's allocations held to the
  card's free memory before it makes them, so that a geometry too big
  for the card raises with what it needed.
"""
from __future__ import annotations

import numpy as np
import torch

# Physical DBB address width: NVDLA's DBB interface and the SoC DRAM map
# are comfortably inside 40 bits (1 TiB).
DRAM_ADDR_BITS = 40


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None.  Raises when
    CUDA is asked for (explicitly or by default) and not available —
    pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default — "
            "pass device='cpu' to run on the CPU")
    return dev


def as_address_tensor(x, *, device: str | torch.device,
                      what: str = "address") -> torch.Tensor:
    """Byte addresses (any int array-like) -> int64 tensor on ``device``.
    Values outside ``[0, 2**DRAM_ADDR_BITS)`` raise instead of being
    carried silently."""
    arr = np.asarray(x, np.int64)
    check_address_range(arr, what)
    return torch.as_tensor(arr, dtype=torch.int64, device=device)


def check_address_range(arr: np.ndarray, what: str = "address") -> None:
    """Raise ``OverflowError`` where an int array holds values outside
    ``[0, 2**DRAM_ADDR_BITS)``."""
    if arr.size and (int(arr.min()) < 0
                     or int(arr.max()) >= 1 << DRAM_ADDR_BITS):
        raise OverflowError(
            f"{what} values outside the {DRAM_ADDR_BITS}-bit DRAM address "
            f"space [0, {1 << DRAM_ADDR_BITS:#x})")


def free_device_bytes(dev: torch.device) -> int:
    """Device memory a new allocation can take: what ``cudaMemGetInfo``
    reports free and what PyTorch's allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev)


def check_device_memory(dev: torch.device, nbytes: int, what: str) -> None:
    """Raise ``MemoryError`` naming ``what`` if ``nbytes`` do not fit a
    CUDA device's free memory (other devices are not checked)."""
    if dev.type != "cuda":
        return
    # what the allocator already holds unused needs no device query
    if nbytes <= torch.cuda.memory_reserved(dev) \
            - torch.cuda.memory_allocated(dev):
        return
    free = free_device_bytes(dev)
    if nbytes > free:
        raise MemoryError(f"{what} need {nbytes:,} bytes of device memory; "
                          f"{free:,} are free")

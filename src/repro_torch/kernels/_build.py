"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  All sources compile at
once, one ``nvcc`` process each, at the first kernel launch of the
process (or an explicit ``build()``).  Libraries land in
``build/kernels/`` at the repository root, named by a hash of their
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is never served stale, each
beside its ``ptxas`` report (``report``).  A failed build raises.

Every launch goes through ``launch_stream``: the C launchers act on the
*current* device (``cudaGetDevice``'s SM count, ``cudaFuncSetAttribute``'s
per-device limits), so the tensors' device is made current around the
call, whichever thread and device the caller runs on.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}   # loaded libraries of this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the port's kernels are "
                           "built from source with the CUDA toolkit")
    return str(path)


def _target(src: Path) -> Path:
    """The library built from ``src``: named by a hash of the source, of
    every ``csrc/*.cuh`` header it may include, and of the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, str]:
    """Compile every kernel source whose library is missing, all
    together, and load every library.  Returns each newly compiled
    source's ``ptxas`` report (registers, shared memory, spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for src in sorted(CSRC.glob("*.cu")):
        if src.stem not in _libs:
            _libs[src.stem] = ctypes.CDLL(str(_target(src)))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        build()
    return _libs[name]


def report(name: str) -> str:
    """The ``ptxas`` report (registers, shared memory, spills of each
    kernel) of the library built from ``csrc/<name>.cu``."""
    library(name)
    return _target(CSRC / f"{name}.cu").with_suffix(".log").read_text()


@contextlib.contextmanager
def launch_stream(dev):
    """The launch guard: CUDA device ``dev`` (the launch's tensors')
    current for the block, which gets the handle of its current stream
    to launch on."""
    import torch

    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero CUDA error returned by a launch function."""
    if err:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({fn(err).decode()})")

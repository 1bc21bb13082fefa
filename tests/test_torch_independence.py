"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points run on CUDA unless asked otherwise."""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.case_study import main as case_study_main  # noqa: E402
from repro_torch.utils.env import (  # noqa: E402
    as_address_tensor,
    default_device,
)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "repro" or n.startswith("repro."))
print(len([n for n in sys.modules if n.startswith("repro_torch")]))
assert not bad, bad
"""


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         env={"PYTHONPATH": str(SRC), "PATH": "",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20, "walked too few modules"


def test_source_has_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                     r"(\.|\s))", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    for f in files:
        assert not pat.search(f.read_text()), f


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        case_study_main([])


def test_default_device_on_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


def test_address_tensor_is_int64_and_checks_40_bits():
    t = as_address_tensor([0, (1 << 40) - 1], device="cpu")
    assert t.dtype == torch.int64 and t.tolist() == [0, (1 << 40) - 1]
    with pytest.raises(OverflowError, match="40-bit"):
        as_address_tensor([1 << 40], device="cpu")
    with pytest.raises(OverflowError, match="40-bit"):
        as_address_tensor([-1], device="cpu")


_IMPORT_LAUNCH = """
import os
before = dict(os.environ)
import torch.distributed as dist
import repro_torch.launch.dryrun
import repro_torch.sharding
import repro_torch.sharding.local
assert dict(os.environ) == before, sorted(
    set(os.environ.items()) ^ set(before.items()))
assert not dist.is_initialized()
print("ok")
"""


def test_importing_the_dryrun_and_sharding_changes_no_state():
    """The reference's dry-run sets XLA_FLAGS when imported; the port's
    sets no environment variable and starts no process group."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_LAUNCH],
                         env={"PYTHONPATH": str(SRC), "PATH": "",
                              "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"

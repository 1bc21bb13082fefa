"""``train.compress.compressed_reduce`` over a bound group against the
reference's inside ``shard_map``: two gloo ranks of the port (a
``FileStore`` on disk) and the reference over two forced host devices,
each in processes of their own, on the same numpy gradients; ``g_hat``
and the error feedback bit-equal on both ranks, two steps running.

The reference runs jitted with ``--xla_cpu_max_isa=SSE4_2``: on a host
with FMA, XLA:CPU contracts the error feedback's ``g - q * scale`` into
one fused multiply-add (one rounding), where the reference's own eager
path and the port round the product and the difference apart.  Without
FMA instructions the jitted reference rounds as its eager path does."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
STEPS = 2

_PORT_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.train.compress import compressed_reduce

rank, store, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
try:
    d = np.load(data)
    ef = {k: torch.zeros(d[f"{k}0"].shape[1:]) for k in ("a", "b")}
    res = {}
    for s in range(int(d["steps"])):
        g = {k: torch.from_numpy(d[f"{k}{s}"][rank]) for k in ("a", "b")}
        g_hat, ef = compressed_reduce(g, ef, axis="pod",
                                      group=dist.group.WORLD)
        for k in ("a", "b"):
            res[f"g_{k}{s}"] = g_hat[k].numpy()
            res[f"e_{k}{s}"] = ef[k].numpy()
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""

_REFERENCE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.train.compress import compressed_reduce

data, out = sys.argv[1], sys.argv[2]
d = np.load(data)
mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))


def body(g, e):
    g = {k: v[0] for k, v in g.items()}
    e = {k: v[0] for k, v in e.items()}
    g_hat, ef = compressed_reduce(g, e, axis="pod")
    return ({k: v[None] for k, v in g_hat.items()},
            {k: v[None] for k, v in ef.items()})


fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                           out_specs=(P("pod"), P("pod")), check_vma=False))
ef = {k: jnp.zeros(d[f"{k}0"].shape) for k in ("a", "b")}
res = {}
for s in range(int(d["steps"])):
    g_hat, ef = fn({k: jnp.asarray(d[f"{k}{s}"]) for k in ("a", "b")}, ef)
    for k in ("a", "b"):
        res[f"g_{k}{s}"] = np.asarray(g_hat[k])
        res[f"e_{k}{s}"] = np.asarray(ef[k])
np.savez(out, **res)
"""


ENV = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", ""),
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
       "XLA_FLAGS": "--xla_force_host_platform_device_count=2 "
                    "--xla_cpu_max_isa=SSE4_2"}


def test_compressed_reduce_over_two_ranks_is_the_references(tmp_path):
    rng = np.random.default_rng(3)
    data = {"steps": STEPS}
    for s in range(STEPS):        # one row per rank
        data[f"a{s}"] = (rng.standard_normal((2, 64)) * 0.1) \
            .astype(np.float32)
        data[f"b{s}"] = rng.standard_normal((2, 3, 4)).astype(np.float32)
    np.savez(tmp_path / "data.npz", **data)

    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp_path / "data.npz"),
         str(tmp_path / "ref.npz")], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _PORT_RANK, str(r), str(tmp_path / "store"),
         str(tmp_path / "data.npz"), str(tmp_path / f"rank{r}.npz")],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in (ref, *ranks):
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        assert p.returncode == 0, err

    want = np.load(tmp_path / "ref.npz")
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key in got.files:
            np.testing.assert_array_equal(got[key], want[key][r],
                                          err_msg=f"rank {r} {key}")
    # the reduced gradient is the same on both ranks; the error feedback
    # is each rank's own
    for s in range(STEPS):
        np.testing.assert_array_equal(want[f"g_a{s}"][0], want[f"g_a{s}"][1])
        assert not np.array_equal(want[f"e_a{s}"][0], want[f"e_a{s}"][1])

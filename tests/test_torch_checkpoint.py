"""The port's checkpoint store: twins of tests/test_checkpoint.py
(atomicity, integrity, GC, async save, restoring onto a chosen device,
the loop's failure injection) and the cross-package format: a converted
train state saved by either package restores in the other with equal
leaves, and both manifests' ``leaves`` entries (index, shape, dtype,
crc32) are equal.  Every comparison is exact."""
from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.checkpoint import save as j_save  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointManager,
    latest_step,
    restore,
    save,
)
from repro_torch.convert import train_state  # noqa: E402
from repro_torch.types import tree_leaves  # noqa: E402


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((8, 16)).astype(
                np.float32)),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def test_roundtrip(tmp_path):
    t = _tree()
    save(t, str(tmp_path), 5)
    out = restore(t, str(tmp_path), 5)
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_ignores_torn(tmp_path):
    t = _tree()
    save(t, str(tmp_path), 1)
    save(t, str(tmp_path), 2)
    # simulate a crash mid-save of step 3: no COMMIT file
    os.makedirs(tmp_path / "step_000000003")
    assert latest_step(str(tmp_path)) == 2


def test_crc_detects_corruption(tmp_path):
    t = _tree()
    path = save(t, str(tmp_path), 1)
    leaf = os.path.join(path, "leaf_00000.npy")
    arr = np.load(leaf)
    arr.flat[0] += 1.0
    np.save(leaf, arr)
    with pytest.raises(IOError):
        restore(t, str(tmp_path), 1)


def test_corrupt_manifest_raises_checkpoint_error(tmp_path):
    t = _tree()
    path = save(t, str(tmp_path), 1)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"treedef": "garb')        # torn mid-write
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        restore(t, str(tmp_path), 1)


def test_missing_leaf_raises_checkpoint_error(tmp_path):
    t = _tree()
    path = save(t, str(tmp_path), 1)
    os.remove(os.path.join(path, "leaf_00001.npy"))
    with pytest.raises(CheckpointCorruptError, match="leaf"):
        restore(t, str(tmp_path), 1)


def test_explicit_restore_of_torn_step_raises(tmp_path):
    t = _tree()
    save(t, str(tmp_path), 1)
    os.remove(os.path.join(tmp_path, "step_000000001", "COMMIT"))
    with pytest.raises(CheckpointCorruptError, match="COMMIT"):
        restore(t, str(tmp_path), 1)


def test_corrupt_error_is_oserror():
    assert issubclass(CheckpointCorruptError, OSError)


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(t, s)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]


def test_restore_onto_a_device(tmp_path):
    """The elastic resume of the port: the saved arrays are whole, and
    ``device=`` places every leaf on the device asked for (the
    reference's ``shardings=``)."""
    t = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    save(t, str(tmp_path), 1)
    out = restore(t, str(tmp_path), 1, device="cpu")
    assert out["w"].device == torch.device("cpu")
    assert torch.equal(out["w"], t["w"])
    meta = {"w": torch.empty((8, 4), device="meta")}
    out = restore(meta, str(tmp_path), 1, device=torch.device("cpu"))
    assert torch.equal(out["w"], t["w"])


def test_loop_failure_injection_and_resume(tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optim import AdamWConfig

    cfg = get_smoke_config("qwen2-0.5b")
    loop_cfg = LoopConfig(total_steps=12, checkpoint_every=4,
                          checkpoint_dir=str(tmp_path), async_save=False,
                          log_every=100)
    boom = {"armed": True}

    def failure_hook(step):
        if step == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure at step 6")

    res = train(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50),
                loop_cfg, global_batch=2, seq_len=16,
                failure_hook=failure_hook, log=lambda s: None, device="cpu")
    assert res.restarts == 1
    assert int(res.state.step) == 12
    # checkpointed resume happened from step 4, so steps 4..6 re-ran
    assert latest_step(str(tmp_path)) == 12


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------
def _states():
    cfg = j_smoke("qwen2-0.5b")
    jstate = j_init_state(j_values(j_init(jax.random.PRNGKey(0), cfg)))
    return jstate, train_state(jax.tree.map(np.asarray, jstate),
                               device="cpu")


def _entries(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["leaves"]


def test_manifests_match_the_references(tmp_path):
    jstate, tstate = _states()
    jpath = j_save(jstate, str(tmp_path / "jax"), 3)
    tpath = save(tstate, str(tmp_path / "torch"), 3)
    assert _entries(tpath) == _entries(jpath)
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_checkpoint_restores_in_the_other_package(tmp_path, writer):
    jstate, tstate = _states()
    if writer == "jax":
        j_save(jstate, str(tmp_path), 7)
        out = restore(tstate, str(tmp_path))
        got, want = tree_leaves(out), jax.tree.leaves(jstate)
    else:
        save(tstate, str(tmp_path), 7)
        out = j_restore(jstate, str(tmp_path))
        got, want = jax.tree.leaves(out), tree_leaves(tstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = (np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
                for x in (a, b))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

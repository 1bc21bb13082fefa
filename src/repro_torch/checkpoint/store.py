"""Checkpoints: manifest + per-leaf arrays + integrity hashes (the
reference's ``repro.checkpoint.store``, on the same disk format).

Layout (one directory per step):

    <dir>/step_000123/
        manifest.json      tree structure, shapes, dtypes, crc32 per leaf
        leaf_00000.npy ... one file per tree leaf, in the reference's
                           leaf order (``types.tree_flatten``)
        COMMIT             written last — a checkpoint without COMMIT is
                           torn (crashed mid-save) and is ignored

The leaves' files and the manifest's ``leaves`` entries (index, shape,
dtype, crc32) are the reference's for the same state, so a checkpoint
written by either package restores in the other.  The manifest's
``treedef`` string is the port's own; ``restore`` reads the structure
from the tree it is given, never from that string.

* atomic commit — every file is fsync'd in a temp directory, COMMIT
  lands last, and a rename publishes the checkpoint;
* ``restore`` validates every leaf's crc32 before handing data back;
* ``restore(..., device=)`` places the leaves on a device (by default
  the device of the matching leaf of ``tree_like``): the saved arrays
  are whole, so a restart may resume anywhere;
* ``restore(..., shardings=, device_mesh=)`` places each leaf straight
  onto a ``DeviceMesh`` with the DTensor placements of the matching
  leaf of ``shardings`` (the reference's ``NamedSharding`` tree), so a
  sharded run resumes onto another mesh (elastic restore).  Every rank
  reads the same whole arrays and keeps its own shards: no collective;
* a DTensor leaf is saved gathered whole (``full_tensor``, a collective
  every rank of its mesh must join, in leaf order);
* async save — ``CheckpointManager(async_save=True)`` copies the state
  to host memory synchronously and writes in a background thread, so
  the train loop only blocks for the device-to-host copy.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.types import tree_flatten, tree_unflatten


class CheckpointCorruptError(OSError):
    """A checkpoint on disk cannot be trusted: torn commit, unreadable
    or tampered manifest, missing leaf file, or a checksum mismatch.
    Subclasses ``OSError`` so callers guarding restores with
    ``except OSError`` keep working.  The message names the artifact
    and the step so an operator can delete exactly the bad directory."""


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (a copy of a tensor, a
    DTensor gathered whole)."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Flush directory metadata (renames, creates) to stable storage;
    silently skipped where directories cannot be opened read-only."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(tree, directory: str, step: int) -> str:
    """Synchronous atomic save: every file is written and fsync'd in a
    temp directory, the COMMIT marker lands last, and the final rename
    (plus parent-directory fsync) publishes the whole checkpoint.
    Returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:09d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    leaves, treedef = tree_flatten(tree)
    manifest = {"treedef": repr(treedef), "n_leaves": len(leaves),
                "step": step, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        with open(os.path.join(tmp, f"leaf_{i:05d}.npy"), "wb") as f:
            np.save(f, arr)
            _fsync_file(f)
        manifest["leaves"].append({
            "index": i, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "crc32": _crc(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        _fsync_file(f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
        _fsync_file(f)
    _fsync_dir(tmp)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _fsync_dir(directory)
    return path


def latest_step(directory: str) -> int | None:
    """Largest committed step in `directory` (ignores torn checkpoints)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            s = int(m.group(1))
            best = s if best is None or s > best else best
    return best


def _is_placements(x) -> bool:
    """A leaf of a ``shardings`` tree: a sequence of DTensor placements,
    one a mesh dimension."""
    from torch.distributed.tensor import Placement

    return isinstance(x, (tuple, list)) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _placed(arr: np.ndarray, placements, device_mesh):
    """A whole saved array as a DTensor of ``placements`` on
    ``device_mesh``: this rank's shards of its own copy, no collective
    (every rank read the same bytes)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(torch.from_numpy(arr), device_mesh,
                             list(placements), src_data_rank=None)


def restore(tree_like, directory: str, step: int | None = None, *,
            device=None, shardings=None, device_mesh=None):
    """Restore into the structure of `tree_like` (values are ignored):
    tensors on ``device``, or, where None, on the device of the matching
    leaf of ``tree_like`` (the CPU for a leaf that is no tensor).

    ``shardings``: a tree matching `tree_like` of DTensor placements
    (``launch.specs.param_sharding_tree``'s leaves) on ``device_mesh``:
    each leaf is placed straight onto it (elastic reshard)."""
    if shardings is not None and (device_mesh is None or device is not None):
        raise ValueError("shardings= places leaves on device_mesh=; pass "
                         "the mesh, and no device=")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise CheckpointCorruptError(
            f"checkpoint {path} has no COMMIT marker — it is torn "
            "(crashed mid-save); delete the directory or restore an "
            "earlier step")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} manifest is unreadable ({e}); the "
            "checkpoint cannot be validated — delete it or restore an "
            "earlier step") from e

    leaves_like, treedef = tree_flatten(tree_like)
    if manifest.get("n_leaves") != len(leaves_like):
        raise ValueError(
            f"checkpoint has {manifest.get('n_leaves')} leaves, "
            f"target tree has {len(leaves_like)}")

    placements = [None] * len(leaves_like)
    if shardings is not None:
        placements = tree_flatten(shardings, is_leaf=_is_placements)[0]
        if len(placements) != len(leaves_like):
            raise ValueError(f"shardings has {len(placements)} leaves, "
                             f"the target tree {len(leaves_like)}")

    out = []
    for entry, like, where in zip(manifest["leaves"], leaves_like,
                                  placements):
        leaf_path = os.path.join(path, f"leaf_{entry['index']:05d}.npy")
        try:
            arr = np.load(leaf_path)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"leaf file {leaf_path} is missing or undeserializable "
                f"({e}) despite a committed manifest — the checkpoint "
                "is corrupt; delete it or restore an earlier step") from e
        if _crc(arr) != entry["crc32"]:
            raise CheckpointCorruptError(
                f"crc mismatch for leaf {entry['index']} in {path}: "
                f"stored {entry['crc32']}, recomputed {_crc(arr)} — the "
                "leaf bytes changed after commit; delete the checkpoint "
                "or restore an earlier step")
        if where is not None:
            out.append(_placed(arr, where, device_mesh))
            continue
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(torch.from_numpy(arr).to(dev))
    return tree_unflatten(treedef, out)


@dataclasses.dataclass
class CheckpointManager:
    """Keeps the last `keep` checkpoints; optional async background writes."""

    directory: str
    keep: int = 3
    async_save: bool = False
    _thread: threading.Thread | None = None

    def save(self, tree, step: int) -> None:
        # snapshot to host synchronously (the caller goes on updating)
        leaves, treedef = tree_flatten(tree)
        host_tree = tree_unflatten(treedef, [_host(x) for x in leaves])
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(host_tree, step), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(host_tree, step)

    def _save_and_gc(self, tree, step: int) -> None:
        save(tree, self.directory, step)
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.directory))
            if m)
        for old in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old:09d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, tree_like, *, device=None, shardings=None,
                       device_mesh=None):
        self.wait()
        return restore(tree_like, self.directory, None, device=device,
                       shardings=shardings, device_mesh=device_mesh)

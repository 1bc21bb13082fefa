"""The port on several CUDA devices of one host.

On the CPU (counted in tier 1):

* each of the kernels' nine ctypes launch sites makes its tensors'
  device current and launches on that device's current stream, through
  the one guard ``kernels._build.launch_stream``: the tensors stand on
  cards 1 and 3 (a CPU tensor whose ``device`` says so), and the guard's
  ``torch.cuda`` calls and the built library are stand-ins that record
  the device current at each launch;
* ``sweep._mesh_lane_metrics`` gives each lane slice its mesh device
  and makes a CUDA device current in its pool thread;
* a checkpointed layer's recompute in another thread (autograd's own,
  on CUDA) places its tensors as the forward did.

On four cards of one host (``gpu4``; each test skips without them, and
no JAX is imported here, so the file runs where the card is):

* the campaign run farm: the 64-point, 16,384-burst acceptance campaign
  on one card (sequential and batched) and over meshes of 2 and 4 cards,
  every manifest byte-identical and equal to the reference's (its sha256
  in ``chip_smoke.py``); a NaN point quarantined alone and a crash inside
  a sharded batch resumed to the sequential manifest, over four cards;
  the campaign CLI with ``--mesh``;
* ``tests/test_torch_dtensor.py``'s five cases over four NCCL ranks, a
  card each, the hand-written kernels on the shards (at the gloo test's
  tolerance, or the SSD kernel's own where the shards run it);
* qwen2-0.5b's training step at full width on a (2, 2) mesh (values in
  fp32 against one card, bf16 steps with async checkpoints, each rank's
  peak memory against the dry-run's trace), a save on (1, 4) restored
  onto (2, 2) through ``restore(shardings=)``, and
  ``compressed_reduce`` over NCCL against gloo.

Run the card part with
``env PYTHONPATH=src python -m pytest -q -s -m gpu4 tests/test_torch_multicard.py``
on a host with four cards (~7 minutes on four H100s, the kernels' build
included).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.convcore import kernel as convcore  # noqa: E402
from repro_torch.kernels.llc import kernel as llc  # noqa: E402
from repro_torch.kernels.noc import kernel as noc  # noqa: E402
from repro_torch.kernels.postproc import kernel as postproc  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd  # noqa: E402
from repro_torch.kernels.swa import kernel as swa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CARDS = (1, 3)     # the devices the launch tests put their tensors on


# --------------------------------------------------------------------------
# the launch guard, on the CPU
# --------------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor whose ``device`` names a card (``card``, set on a
    subclass a card): the wrappers' checks and pointers see a CUDA
    tensor, and what the wrappers make from it stays on that card."""
    card = 0

    @property
    def device(self):
        return torch.device("cuda", type(self).card)


_CLASSES: dict = {}


def on_card(t: torch.Tensor, card: int) -> torch.Tensor:
    cls = _CLASSES.setdefault(card, type(f"_OnCard{card}", (_OnCard,),
                                         {"card": card}))
    return torch.Tensor._make_subclass(cls, t.contiguous())


class _Launches:
    """The guard's ``torch.cuda`` calls and the built libraries, as
    stand-ins: ``device`` is the current device, each card's current
    stream is ``STREAM + card``, and every library call returns 0 after
    recording (name, current device, last argument)."""
    STREAM = 1000

    def __init__(self):
        self.current = 0
        self.calls: list = []
        launches = self

        class Device:
            def __init__(self, dev):
                self.dev = torch.device(dev)

            def __enter__(self):
                assert self.dev.type == "cuda"
                self.prev, launches.current = launches.current, self.dev.index

            def __exit__(self, *exc):
                launches.current = self.prev

        class Stream:
            def __init__(self, card):
                self.cuda_stream = launches.STREAM + card

        class Library:
            def __getattr__(self, name):
                def call(*args):
                    launches.calls.append((name, launches.current,
                                           args[-1] if args else None))
                    return 0
                return call

        self.device = Device
        self.stream = lambda dev: Stream(torch.device(dev).index)
        self.library = Library()

    def patch(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device", self.device)
        monkeypatch.setattr(torch.cuda, "current_stream", self.stream)
        monkeypatch.setattr(_build, "library", lambda name: self.library)
        for mod in (convcore, llc, noc, postproc, ssd, swa):
            for cache in ("_lib", "_bwd_lib"):
                if hasattr(mod, cache):
                    monkeypatch.setattr(mod, cache, None)
        real_empty = torch.empty

        def empty(*size, device=None, **kw):
            if device is not None and torch.device(device).type == "cuda":
                return on_card(real_empty(*size, **kw),
                               torch.device(device).index)
            return real_empty(*size, device=device, **kw)

        monkeypatch.setattr(torch, "empty", empty)
        monkeypatch.setattr(
            torch.cuda, "get_device_properties",
            lambda dev: type("Props", (), {"multi_processor_count": 1}))
        monkeypatch.setattr(llc, "_upload", lambda a, dev: on_card(
            torch.from_numpy(np.ascontiguousarray(a)), torch.device(dev).index))


def _zeros(shape, dtype, card):
    return on_card(torch.zeros(shape, dtype=dtype), card)


def _convcore(card):
    a = _zeros((64, 32), torch.int8, card)
    bt = _zeros((64, 32), torch.int8, card)
    scale, bias = (_zeros((64,), torch.float32, card) for _ in range(2))
    out = _zeros((64, 64), torch.float32, card)
    convcore.matmul_int8_kernel(a, bt, scale, bias, out, relu=True)
    return {"convcore_matmul_int8"}


def _postproc(card):
    x = _zeros((1, 4, 4, 16), torch.float32, card)
    scale, bias = (_zeros((16,), torch.float32, card) for _ in range(2))
    out = _zeros((1, 2, 2, 16), torch.float32, card)
    postproc.postprocess_kernel(x, scale, bias, out, act="relu", pool=2)
    return {"postproc_launch"}


def _ssd_args(card):
    x = _zeros((1, 1, 4, 2, 4), torch.float32, card)
    dt, cum = (_zeros((1, 1, 4, 2), torch.float32, card) for _ in range(2))
    B, C = (_zeros((1, 1, 4, 4), torch.float32, card) for _ in range(2))
    return x, dt, cum, B, C


def _ssd(card):
    ssd.ssd_intra_chunk_kernel(*_ssd_args(card))
    return {"ssd_intra_chunk_launch"}


def _ssd_bwd(card):
    x, dt, cum, B, C = _ssd_args(card)
    gy = _zeros(x.shape, torch.float32, card)
    gst = _zeros((1, 1, 2, 4, 4), torch.float32, card)
    ssd.ssd_intra_chunk_bwd_kernel(x, dt, cum, B, C, gy, gst)
    return {"ssd_bwd_launch"}


def _swa_args(card):
    q = _zeros((1, 8, 2, 16), torch.float32, card)
    k, v = (_zeros((1, 8, 1, 16), torch.float32, card) for _ in range(2))
    return q, k, v


def _swa(card):
    swa.swa_attention_kernel(*_swa_args(card), window=8, scale=0.25)
    return {"swa_fma_launch"}


def _swa_bwd(card):
    q, k, v = _swa_args(card)
    o, do = (_zeros(q.shape, torch.float32, card) for _ in range(2))
    swa.swa_attention_bwd_kernel(q, k, v, o, do, window=8, scale=0.25)
    return {"swa_bwd_fma_launch"}


def _set_walk(card):
    llc.set_walk_kernel(
        _zeros((2, 4), torch.int32, card), _zeros((2, 4), torch.int32, card),
        _zeros((5,), torch.int32, card), _zeros((5,), torch.int32, card),
        _zeros((2,), torch.int64, card), _zeros((2,), torch.int64, card),
        _zeros((5,), torch.bool, card))
    return {"llc_set_walk_launch"}


def _lane_scan(card):
    buckets, outs = [], []
    for ways in (4, 256):      # a thread-route and a warp-route bucket
        table = _zeros((2, 3, len(llc.FIELDS)), torch.int64, card)
        rounds = _zeros((3,), torch.int32, card)
        geo = _zeros((2, 3), torch.int64, card)
        sizes = llc.bucket_sizes(table, rounds, geo, max_sets=4,
                                 max_ways=ways, r_pad=1, suffix="none")
        buckets.append((table, rounds, geo, sizes))
        state = (2, ways, 4)
        outs.append((_zeros((2, 3), torch.int64, card), None,
                     _zeros(state, torch.int32, card),
                     _zeros(state, torch.int32, card)))
    llc.lane_scan_kernel(buckets, outs, [3, 3])
    return {"llc_lane_scan_launch", "llc_lane_scan_wide_launch"}


def _switch(card):
    ports, h_pad = 4, 8
    noc.switch_kernel(
        _zeros((6, ports), torch.int32, card), _zeros((3,), torch.int32, card),
        _zeros((h_pad, ports), torch.bool, card),
        _zeros((h_pad, ports), torch.int32, card),
        _zeros((h_pad, ports), torch.int32, card), None, None,
        link=1, depth=4, total=6, bundle=8, n_chunks=1)
    return {"noc_switch_launch"}


LAUNCHERS = {"convcore": _convcore, "postproc": _postproc, "ssd": _ssd,
             "ssd_bwd": _ssd_bwd, "swa": _swa, "swa_bwd": _swa_bwd,
             "llc_set_walk": _set_walk, "llc_lane_scan": _lane_scan,
             "noc_switch": _switch}


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_enters_the_guard_with_its_tensors_device(name,
                                                           monkeypatch):
    """Every launch runs with its tensors' card current and on that
    card's current stream, whichever card is current before."""
    launches = _Launches()
    launches.patch(monkeypatch)
    for card in CARDS:
        before = len(launches.calls)
        want = LAUNCHERS[name](card)
        made = [c for c in launches.calls[before:] if c[0] in want]
        assert {c[0] for c in made} == want, launches.calls[before:]
        assert all(c[1:] == (card, _Launches.STREAM + card)
                   for c in made), made
        assert launches.current == 0      # the guard restored device 0


def test_mesh_lane_metrics_gives_each_slice_its_device(monkeypatch):
    """Lane slice d (contiguous, the first lanes % n slices one longer)
    runs on mesh device d, with that device current in its thread."""
    import threading

    from repro_torch.core import sweep
    from repro_torch.launch.mesh import make_sweep_mesh

    launches = _Launches()
    monkeypatch.setattr(torch.cuda, "device", launches.device)
    seen, lock = [], threading.Lock()

    def batch(segs, *, llcs, drams, mixes, chunk_bursts, t_llc_hit, device):
        with lock:
            seen.append((device, launches.current, list(llcs)))
        return [(device, lane) for lane in llcs]

    monkeypatch.setattr(sweep, "interference_lane_metrics_batch", batch)
    lanes = list(range(11))
    devices = [torch.device("cuda", i) for i in (2, 0, 3, 1)]
    got = sweep._mesh_lane_metrics(
        [], llcs=lanes, drams=lanes, mixes=lanes, chunk_bursts=16,
        t_llc_hit=20, mesh=make_sweep_mesh(devices))
    assert got == [(devices[d], lane) for d, lo, hi in
                   ((0, 0, 3), (1, 3, 6), (2, 6, 9), (3, 9, 11))
                   for lane in range(lo, hi)]
    assert sorted((d.index, cur, ls) for d, cur, ls in seen) == sorted(
        (devices[d].index, devices[d].index, list(range(lo, hi)))
        for d, lo, hi in ((0, 0, 3), (1, 3, 6), (2, 6, 9), (3, 9, 11)))
    # CPU slices (the tests' meshes) make no CUDA device current
    seen.clear()
    sweep._mesh_lane_metrics([], llcs=lanes[:2], drams=lanes[:2],
                             mixes=lanes[:2], chunk_bursts=16, t_llc_hit=20,
                             mesh=make_sweep_mesh(["cpu"] * 3))
    assert sorted((str(d), cur) for d, cur, _ in seen) == [("cpu", 0)] * 2


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-130m",
                                  "mixtral-8x7b", "qwen2-0.5b",
                                  "recurrentgemma-9b"])
def test_remat_recompute_in_another_thread_sees_the_forwards_sharding(arch):
    """On CUDA autograd runs the backward, and so a checkpointed layer's
    recompute, in a thread of its own, where the sharding rules of the
    forward pass are not active: the recompute must place its tensors as
    the forward did (else ``CheckpointError``).  Here the smoke loss runs
    sharded on a (2, 2) mesh over a placeholder world (meta tensors) and
    its backward in another thread with no rules, DTensor's implicit
    replication on there as it is process-wide in the card's torch."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import batch_shardings, param_sharding_tree
    from repro_torch.models import init_params, loss_fn
    from repro_torch.sharding import activate_rules
    from repro_torch.types import param_values, tree_flatten, tree_unflatten

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    assert cfg.remat
    out: dict = {}
    with dryrun.placeholder_world(WORLD):
        mesh = _mesh((2, 2), "cpu")
        with activate_rules(mesh), implicit_replication(), \
                dryrun._all_to_all_as_on_gpus():
            params_p = init_params(0, cfg, device="meta")
            flat, treedef = tree_flatten(dryrun.distribute(
                param_values(params_p), param_sharding_tree(params_p),
                mesh.device_mesh))
            leaves = [p.detach().requires_grad_() for p in flat]
            batch = {k: torch.empty((4, 32), dtype=torch.int32,
                                    device="meta")
                     for k in ("tokens", "labels")}
            loss, _ = loss_fn(tree_unflatten(treedef, leaves), dryrun.distribute(
                batch, batch_shardings(batch), mesh.device_mesh), cfg)

            def backward():
                try:
                    with implicit_replication():
                        out["grads"] = torch.autograd.grad(loss, leaves)
                except Exception as e:   # noqa: BLE001 - read below
                    out["error"] = e

            thread = threading.Thread(target=backward)
            thread.start()
            thread.join(timeout=120)
    assert not thread.is_alive() and "error" not in out, out.get("error")
    assert len(out["grads"]) == len(leaves)


# --------------------------------------------------------------------------
# four cards of one host
# --------------------------------------------------------------------------
def _four_cards() -> list:
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip("needs four CUDA cards of one host")
    return [torch.device("cuda", i) for i in range(WORLD)]


def _card_names() -> str:
    """``nvidia-smi``'s name and power limit of each card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _sync(devices) -> None:
    for d in devices:
        torch.cuda.synchronize(d)


@pytest.fixture(scope="module")
def farm():
    """The acceptance spec (64 points, one 16,384-burst window, its
    trace memoized), its manifest's sha256 from the JAX reference, and
    the four cards, each warmed by a small campaign over all of them."""
    from repro_torch.campaign import run_campaign
    from repro_torch.launch.mesh import make_sweep_mesh

    import tempfile

    devices = _four_cards()
    cs = _chip_smoke()
    spec = cs.acceptance_spec(64, 16384)
    spec.models[0].trace()
    with tempfile.TemporaryDirectory() as warm:
        run_campaign(cs.acceptance_spec(16, 256), warm,
                     mesh=make_sweep_mesh(devices))
    return spec, cs.CAMPAIGN_ACCEPTANCE_SHA256, devices


def _sha(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.mark.gpu4
def test_run_farm_manifests_identical_over_one_two_and_four_cards(
        farm, tmp_path):
    """Sequential and batched on one card, batched over meshes of 2 and
    4 cards, in turns: every manifest byte-identical, == the reference's,
    no batch fallen back to sequential; points/s of each printed."""
    from repro_torch.campaign import run_campaign
    from repro_torch.launch.mesh import make_sweep_mesh

    spec, want, devices = farm
    runs = [("sequential, 1 card", dict(batch_points=1, device=devices[0]))]
    for n in (1, 2, 4, 4, 2, 1):
        kw = dict(batch_points=64, device=devices[0]) if n == 1 else \
            dict(batch_points=64, mesh=make_sweep_mesh(devices[:n]))
        runs.append((f"batched, {n} card{'s' * (n > 1)}", kw))
    rates: dict = {}
    for i, (name, kw) in enumerate(runs):
        notes: list = []
        _sync(devices)
        t0 = time.perf_counter()
        res = run_campaign(spec, str(tmp_path / str(i)),
                           progress=notes.append, **kw)
        _sync(devices)
        wall = time.perf_counter() - t0
        rates.setdefault(name, []).append(64 / wall)
        fell = [n for n in notes if "fell back" in n]
        assert res.completed == 64 and not res.failed and not fell, \
            (name, res.manifest["counts"], fell)
        assert _sha(res.manifest_path) == want, name
    print(f"\nrun farm, 64 points x 16,384 bursts, manifests byte-identical "
          f"== the reference's; points/s (in turns): "
          f"{json.dumps({k: [round(r, 3) for r in v] for k, v in rates.items()})}"
          f"; cards: {_card_names()!r}")


@pytest.mark.gpu4
def test_run_farm_quarantines_a_nan_point_alone_over_four_cards(farm,
                                                                tmp_path):
    from repro_torch.campaign import (FaultInjector, RetryPolicy,
                                      plan_from_indices, run_campaign)
    from repro_torch.launch.mesh import make_sweep_mesh

    spec, _, devices = farm
    plan = plan_from_indices(spec, [{"point": 2, "kind": "nan"}])
    res = run_campaign(spec, str(tmp_path), batch_points=64,
                       mesh=make_sweep_mesh(devices),
                       policy=RetryPolicy(max_retries=0, backoff_s=0),
                       hooks=FaultInjector(plan, str(tmp_path)))
    assert res.manifest["counts"] == {"total": 64, "completed": 63,
                                      "failed": 1}
    (info,) = res.failed.values()
    assert "finite" in info["error"]


@pytest.mark.gpu4
@pytest.mark.parametrize("kill_at,batch", [(5, 16), (37, 64)])
def test_run_farm_crash_in_a_sharded_batch_resumes_to_the_sequential_manifest(
        farm, kill_at, batch, tmp_path):
    from repro_torch.campaign import (FaultInjector, InjectedCrash,
                                      RetryPolicy, plan_from_indices,
                                      run_campaign)
    from repro_torch.launch.mesh import make_sweep_mesh

    spec, want, devices = farm
    plan = plan_from_indices(spec, [{"point": kill_at, "kind": "crash"}])
    for runs in range(1, 6):
        try:
            res = run_campaign(
                spec, str(tmp_path), resume=runs > 1, batch_points=batch,
                mesh=make_sweep_mesh(devices),
                policy=RetryPolicy(max_retries=1, backoff_s=0),
                hooks=FaultInjector(plan, str(tmp_path)))
            break
        except InjectedCrash:
            continue
    assert runs == 2 and not res.failed and res.completed == 64
    assert _sha(res.manifest_path) == want


@pytest.mark.gpu4
def test_campaign_cli_mesh_over_four_cards(farm, tmp_path):
    spec, want, _ = farm
    spec.save(str(tmp_path / "spec.json"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.campaign", "run",
         str(tmp_path / "spec.json"), "--out", str(tmp_path / "out"),
         "--mesh"], capture_output=True, text=True, env=env, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    assert f"sweep mesh: {WORLD} device(s)" in done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == {
        "total": 64, "completed": 64, "failed": 0}
    assert _sha(tmp_path / "out" / "manifest.json") == want


# the kernels each smoke case runs on its shards
CASE_KERNELS = {"qwen2-0.5b": ("swa", "swa_bwd"),
                "mixtral-8x7b": ("swa", "swa_bwd"),
                "mamba2-130m": ("ssd", "ssd_bwd"),
                "recurrentgemma-9b": ("swa", "swa_bwd"),
                "grok-1-314b": ("swa", "swa_bwd")}


@pytest.fixture(scope="module")
def nccl_runs(tmp_path_factory):
    """arch -> ``tests/test_torch_dtensor.py``'s case on four NCCL
    ranks, a card each, spawned once an arch (the kernels built once,
    here, before)."""
    from test_torch_dtensor import CASES, spawn

    _four_cards()
    _build.build()
    runs: dict = {}

    def get(arch):
        if arch not in runs:
            runs[arch] = spawn({arch: CASES[arch]},
                               tmp_path_factory.mktemp(arch), "nccl")[arch]
        return runs[arch]
    return get


@pytest.mark.gpu4
@pytest.mark.parametrize("arch", sorted(CASE_KERNELS))
def test_sharded_step_equals_plain_over_nccl(arch, nccl_runs):
    """The sharded loss, gradients, microbatched step and split-K decode
    on a (2, 2) mesh of four cards against the plain step on one card,
    at the gloo test's RTOL / ATOL, with the hand-written kernels
    launched on the shards, or, where the shards run the SSD kernels
    (3xTF32), at the kernel's own tolerance; and the elastic restore
    over NCCL."""
    from test_torch_dtensor import (ATOL, KERNEL_ATOL, KERNEL_RTOL, RTOL,
                                    over_tolerance)

    got = nccl_runs(arch)
    worst = max((v for k, v in got["gaps"].items()
                 if k != "split-K shards"), key=lambda v: v[0])
    kernel = "ssd" in CASE_KERNELS[arch]
    print(f"\n{arch}: largest gap {worst[0]:.3e}, kernel launches on the "
          f"shards {got['launches']}; past rtol {RTOL}, atol {ATOL}: "
          f"{over_tolerance(got['gaps'])}")
    over = over_tolerance(got["gaps"], kernel)
    assert not over, (f"{arch}: over rtol "
                      f"{KERNEL_RTOL if kernel else RTOL}, atol "
                      f"{KERNEL_ATOL if kernel else ATOL}: {over}")
    assert all(got["launches"][k] > 0 for k in CASE_KERNELS[arch]), got
    for shape, r in got["restore"].items():
        assert r["placed"] and r["equal"] and r["sharded"] > 0, (shape, r)


# --------------------------------------------------------------------------
# qwen2-0.5b's training step at full width on four cards
# --------------------------------------------------------------------------
# the reference's training arch (arXiv:2407.10671) at full width and
# depth, chip_smoke.py train_path's batch of 4 x 1024 synthetic tokens
FULL_ARCH, FULL_BATCH, FULL_SEQ = "qwen2-0.5b", 4, 1024
# fp32 with TF32 off, (2, 2) shards against one card: the two runs sum in
# other orders only.  The loss within LOSS_RTOL of itself, each gradient
# leaf's largest gap within LEAF_RTOL of its largest magnitude.
LOSS_RTOL, LEAF_RTOL = 1e-5, 1e-4
BF16_STEPS, CKPT_EVERY = 4, 2
# a rank's own step peak (max_memory_allocated less memory_allocated
# before the step) against the dry-run's trace of the same mesh and shape
MEMORY_RTOL, MEMORY_ATOL = 0.05, 256 * 2**20


def _opt():
    from repro_torch.train.optim import AdamWConfig

    return AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)


def _mesh(shape, device_type):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), device_type=device_type)


def _state_shardings(cfg, mesh):
    """(a meta train state of ``cfg``, its placements on ``mesh``)."""
    from repro_torch.launch.specs import abstract_train_state
    from repro_torch.sharding import activate_rules

    with activate_rules(mesh):
        return abstract_train_state(cfg)


def _state_on(state, sh, device_mesh):
    """A train state's tensors as DTensors of the placements ``sh``."""
    from repro_torch.launch.dryrun import distribute

    return dataclasses.replace(
        state, params=distribute(state.params, sh.params, device_mesh),
        opt=distribute(state.opt, sh.opt, device_mesh),
        step=distribute(state.step, sh.step, device_mesh))


def _batches(cfg, batch, seq, dev):
    from repro_torch.data.synthetic import SyntheticStream

    stream = SyntheticStream(cfg, batch, seq, seed=0, device=dev)
    return lambda i: {k: v.contiguous()
                      for k, v in stream.batch_at(i).items()}


def _on_mesh(batch, mesh):
    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.specs import batch_shardings

    return distribute(batch, batch_shardings(batch), mesh.device_mesh)


def _sync_dev(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _join_gathers(tree) -> None:
    """Join a rank-0 save's gathers of ``tree``'s DTensors, in leaf
    order, on a rank that writes nothing."""
    from repro_torch.types import tree_leaves

    for x in tree_leaves(tree):
        if hasattr(x, "full_tensor"):
            x.full_tensor()


@contextlib.contextmanager
def _recording_int32_sums(sums: list):
    """``torch.distributed.all_reduce`` that keeps a copy of each int32
    payload it reduced (``compressed_reduce``'s widened int8 sums)."""
    import torch.distributed as dist

    real = dist.all_reduce

    def all_reduce(t, *args, **kw):
        out = real(t, *args, **kw)
        if t.dtype == torch.int32 and t.dim() > 0:
            sums.append(t.cpu().clone())
        return out

    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        dist.all_reduce = real


def _compress_over_two_backends(device_type: str) -> dict:
    """``compressed_reduce`` of one seeded gradient tree a rank over the
    world's backend (NCCL, on the cards) and over a gloo group of the
    same ranks (on the CPU): the int32 payload sums, the reduced
    gradients and the error feedback of the two."""
    import torch.distributed as dist

    from repro_torch.train.compress import compressed_reduce
    from test_torch_dtensor import _device

    rank = dist.get_rank()
    rng = np.random.default_rng(100 + rank)
    host = {"w": (rng.standard_normal((257, 33)) * (1 + rank)),
            "b": rng.standard_normal(1000) * 1e-3}
    feedback = {k: rng.standard_normal(v.shape) * 1e-2
                for k, v in host.items()}
    out = {}
    for name, dev, group in (
            ("world", _device(device_type), dist.group.WORLD),
            ("gloo", torch.device("cpu"), dist.new_group(backend="gloo"))):
        g, e = ({k: torch.from_numpy(v.astype(np.float32)).to(dev)
                 for k, v in t.items()} for t in (host, feedback))
        sums: list = []
        with _recording_int32_sums(sums):
            reduced, ef = compressed_reduce(g, e, axis="pod", group=group)
        out[name] = (sums, {k: v.cpu() for k, v in reduced.items()},
                     {k: v.cpu() for k, v in ef.items()})
    (s1, r1, e1), (s2, r2, e2) = out["world"], out["gloo"]
    return {"payloads": len(s1),
            "int32_equal": len(s1) == len(s2) == len(host) and all(
                torch.equal(a, b) for a, b in zip(s1, s2)),
            "reduced_equal": all(torch.equal(r1[k], r2[k]) for k in host),
            "ef_equal": all(torch.equal(e1[k], e2[k]) for k in host)}


def _fp32_step(cfg, batch, seq, device_type) -> dict:
    """(a): one fp32 loss-and-gradient step on the (2, 2) mesh against
    the same step on one card (rank 0's): the loss's relative gap and
    each gradient leaf's largest gap over its largest magnitude."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.specs import param_sharding_tree
    from repro_torch.models import init_params
    from repro_torch.sharding import activate_rules
    from repro_torch.train.step import grads_of
    from repro_torch.types import param_values, tree_leaves
    from test_torch_dtensor import _device, _full

    dev = _device(device_type)
    rank0 = dist.get_rank() == 0
    cfg = dataclasses.replace(cfg, dtype="float32")
    params_p = init_params(0, cfg, device=dev)
    params = param_values(params_p)
    b0 = _batches(cfg, batch, seq, dev)(0)
    mesh = _mesh((2, 2), device_type)
    with activate_rules(mesh), implicit_replication():
        dparams = distribute(params, param_sharding_tree(params_p),
                             mesh.device_mesh)
        g, m = grads_of(dparams, _on_mesh(b0, mesh), cfg)
    del dparams
    loss = float(_full(m["loss"]))
    want_g, want_m = grads_of(params, b0, cfg) if rank0 else (None, None)
    want = tree_leaves(want_g) if rank0 else [None] * len(tree_leaves(g))
    leaves = []
    for i, (a, w) in enumerate(zip(tree_leaves(g), want)):
        full = _full(a)
        if rank0:
            top = float(w.abs().max())
            leaves.append({"leaf": i, "shape": list(w.shape),
                           "placements": str(getattr(a, "placements", "")),
                           "max": top, "gap": float((full - w).abs().max()),
                           "rel": float((full - w).abs().max()) / top})
    if not rank0:
        return {}
    plain = float(want_m["loss"])
    return {"loss": loss, "plain_loss": plain,
            "loss_rel": abs(loss - plain) / abs(plain), "leaves": leaves}


def _bf16_steps(cfg, batch, seq, device_type, ckpt_dir) -> dict:
    """(b): ``BF16_STEPS`` steps of ``cfg`` (bf16 compute, fp32
    parameters and moments) on the (2, 2) mesh, an async checkpoint every
    ``CKPT_EVERY`` (rank 0 writes; every rank joins the gathers): each
    step's wall, each save's blocking wall, the first step's own peak
    memory on this rank, the latest committed step."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.launch.dryrun import distribute
    from repro_torch.models import init_params
    from repro_torch.sharding import activate_rules
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.types import param_values
    from test_torch_dtensor import _device, _full

    import gc

    dev = _device(device_type)
    rank0 = dist.get_rank() == 0
    mesh = _mesh((2, 2), device_type)
    _, sh = _state_shardings(cfg, mesh)
    batch_at = _batches(cfg, batch, seq, dev)
    step_fn = make_train_step(cfg, _opt())
    manager = CheckpointManager(str(ckpt_dir), keep=1, async_save=True)
    losses, walls, saves, peak = [], [], [], None
    with activate_rules(mesh), implicit_replication():
        state = _state_on(init_train_state(param_values(init_params(
            0, cfg, device=dev))), sh, mesh.device_mesh)
        for i in range(BF16_STEPS):
            dbatch = _on_mesh(batch_at(i), mesh)
            if i == 0 and dev.type == "cuda":
                gc.collect()
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            _sync_dev(dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, dbatch)
            losses.append(float(_full(metrics["loss"])))
            _sync_dev(dev)
            walls.append(time.perf_counter() - t0)
            if i == 0 and dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev) - base
            if (i + 1) % CKPT_EVERY == 0:
                t0 = time.perf_counter()
                if rank0:
                    manager.save(state, i + 1)
                else:
                    _join_gathers(state)
                saves.append(time.perf_counter() - t0)
    manager.wait()
    dist.barrier()
    return {"losses": losses, "walls": walls, "saves": saves,
            "peak_bytes": peak, "latest": latest_step(str(ckpt_dir))}


def _elastic(cfg, batch, seq, device_type, ckpt_dir) -> dict:
    """(c): one fp32 step on the (1, 4) mesh, saved; restored straight
    onto (2, 2) by ``restore(shardings=)`` (A), and restored onto (1, 4),
    gathered whole and placed on (2, 2) (B); A and B go on two steps.
    Rank 0 also restores it whole on its card (C) and goes on two steps."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.dryrun import distribute
    from repro_torch.models import init_params
    from repro_torch.sharding import activate_rules
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.types import param_values, tree_flatten, tree_leaves
    from repro_torch.types import tree_unflatten
    from test_torch_dtensor import _device, _full

    dev = _device(device_type)
    rank0 = dist.get_rank() == 0
    cfg = dataclasses.replace(cfg, dtype="float32")
    batch_at = _batches(cfg, batch, seq, dev)
    step_fn = make_train_step(cfg, _opt())
    mesh14, mesh22 = _mesh((1, 4), device_type), _mesh((2, 2), device_type)
    like14, sh14 = _state_shardings(cfg, mesh14)
    like22, sh22 = _state_shardings(cfg, mesh22)

    def steps(state, mesh, first, n):
        losses = []
        with (activate_rules(mesh) if mesh else contextlib.nullcontext()), \
                implicit_replication():
            for i in range(first, first + n):
                b = batch_at(i)
                state, m = step_fn(state, _on_mesh(b, mesh) if mesh else b)
                losses.append(float(_full(m["loss"])))
        return state, losses

    with activate_rules(mesh14), implicit_replication():
        state = _state_on(init_train_state(param_values(init_params(
            0, cfg, device=dev))), sh14, mesh14.device_mesh)
    state, _ = steps(state, mesh14, 0, 1)
    if rank0:
        save(state, str(ckpt_dir), 1)
    else:
        _join_gathers(state)
    dist.barrier()
    del state

    a = restore(like22, str(ckpt_dir), 1, shardings=sh22,
                device_mesh=mesh22.device_mesh)
    placed = all(x.device_mesh is mesh22.device_mesh
                  and tuple(x.placements) == tuple(p) for x, p in zip(
                      tree_leaves(a), tree_flatten(
                          sh22, is_leaf=lambda s: isinstance(s, tuple) and s
                          and hasattr(s[0], "is_shard"))[0]))
    a, losses_a = steps(a, mesh22, 1, 2)

    r14 = restore(like14, str(ckpt_dir), 1, shardings=sh14,
                  device_mesh=mesh14.device_mesh)
    leaves, treedef = tree_flatten(r14)
    del r14
    whole = tree_unflatten(treedef, [_full(x) for x in leaves])
    del leaves
    plain = restore(like22, str(ckpt_dir), 1, device=dev) if rank0 else None
    exact = rank0 and all(torch.equal(w, p) for w, p in zip(
        tree_leaves(whole), tree_leaves(plain)))
    b = _state_on(whole, sh22, mesh22.device_mesh)
    del whole
    b, losses_b = steps(b, mesh22, 1, 2)
    same = losses_a == losses_b and all(
        torch.equal(x.to_local(), y.to_local())
        for x, y in zip(tree_leaves(a), tree_leaves(b)))
    flag = torch.tensor([int(same)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    del a, b
    losses_c = steps(plain, None, 1, 2)[1] if rank0 else None
    return {"placed": placed, "losses_a": losses_a, "losses_b": losses_b,
            "identical": bool(flag.item()), "restore_exact": exact,
            "losses_c": losses_c}


def _full_width_worker(rank: int, store_path: str, work: str, out_path: str,
                       backend: str = "nccl", smoke: bool = False,
                       batch: int = FULL_BATCH, seq: int = FULL_SEQ) -> None:
    """One rank of the full-width run (``smoke``: the arch's smoke
    config, to rehearse the run on gloo ranks on the CPU); rank 0 writes
    every rank's record to ``out_path``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config

    device_type = "cuda" if backend == "nccl" else "cpu"
    kw = {}
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        # a rank that dies leaves the others waiting: not for long
        kw.update(device_id=torch.device("cuda", rank),
                  timeout=datetime.timedelta(minutes=4))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, **kw)
    try:
        cfg = (get_smoke_config if smoke else get_config)(FULL_ARCH)
        work = Path(work)
        rec = {"compress": _compress_over_two_backends(device_type)}
        t0 = time.perf_counter()
        rec["fp32"] = _fp32_step(cfg, batch, seq, device_type)
        rec["bf16"] = _bf16_steps(cfg, batch, seq, device_type,
                                  work / "bf16")
        rec["elastic"] = _elastic(cfg, batch, seq, device_type,
                                  work / "elastic")
        rec["wall_s"] = time.perf_counter() - t0
        ranks = [None] * WORLD
        dist.all_gather_object(ranks, rec)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(ranks, f)
    finally:
        dist.destroy_process_group()


def traced_step_peak(cfg, batch: int, seq: int, shape=(2, 2)) -> int:
    """The dry-run's traced peak of the train step of ``cfg`` on a mesh
    of ``shape`` over a placeholder world: the most bytes live at once
    among the storages allocated inside the step on one device."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.sharding import activate_rules

    with dryrun.placeholder_world(WORLD):
        mesh = _mesh(shape, "cpu")
        with activate_rules(mesh), implicit_replication(), \
                dryrun._all_to_all_as_on_gpus():
            step, args = dryrun.build_step(
                cfg, ShapeConfig("multicard", seq, batch, "train"),
                mesh.device_mesh)
            _, memory = dryrun.step_memory(step, *args)
    return memory["peak_bytes"] - memory["argument_bytes"]


def run_full_width(work: Path, backend: str = "nccl", smoke: bool = False,
                   batch: int = FULL_BATCH, seq: int = FULL_SEQ) -> dict:
    """``_full_width_worker`` on ``WORLD`` spawned ranks, the dry-run's
    trace of the bf16 step taken here meanwhile: {"ranks": each rank's
    record, "traced_bytes"} (the trace's error instead, if it failed:
    only the memory test reads it)."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config, get_smoke_config

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = work / "ranks.json"
    ctx = mp.start_processes(
        _full_width_worker, args=(str(work / "store"), str(work), str(out),
                                  backend, smoke, batch, seq),
        nprocs=WORLD, start_method="spawn", join=False)
    try:
        cfg = (get_smoke_config if smoke else get_config)(FULL_ARCH)
        traced = traced_step_peak(cfg, batch, seq)
    except Exception as e:     # noqa: BLE001 - the ranks' records stand
        traced = f"{type(e).__name__}: {e}"
    finally:
        while not ctx.join():
            pass
    ranks = json.loads(out.read_text())
    shutil.rmtree(work, ignore_errors=True)
    return {"ranks": ranks, "traced_bytes": traced}


@pytest.fixture(scope="module")
def full_width():
    _four_cards()
    _build.build()
    rec = run_full_width(ROOT / "build" / "multicard")
    print(f"\nfull-width records: {json.dumps(rec)}")
    return rec


def _tag() -> str:
    return f"cards: {_card_names()!r}"


@pytest.mark.gpu4
def test_full_width_fp32_step_on_four_cards_equals_one_card(full_width):
    rec = full_width["ranks"][0]["fp32"]
    worst = max(rec["leaves"], key=lambda r: r["rel"])
    print(f"\n(a) {FULL_ARCH} fp32, TF32 off, (2, 2) mesh against one card: "
          f"loss {rec['loss']!r} vs {rec['plain_loss']!r}, relative gap "
          f"{rec['loss_rel']:.3e} (bound {LOSS_RTOL}); leaves' gap / "
          f"max |leaf|: "
          f"{[f'{r['leaf']}:{r['rel']:.2e}' for r in rec['leaves']]}, "
          f"largest {worst} (bound {LEAF_RTOL}); {_tag()}")
    assert rec["loss_rel"] <= LOSS_RTOL
    assert all(r["rel"] <= LEAF_RTOL for r in rec["leaves"]), worst


@pytest.mark.gpu4
def test_full_width_bf16_steps_with_async_checkpoints(full_width):
    ranks = [r["bf16"] for r in full_width["ranks"]]
    tokens = FULL_BATCH * FULL_SEQ
    for i, r in enumerate(ranks):
        walls = r["walls"]
        print(f"\n(b) rank {i}: step walls (s) {[round(w, 4) for w in walls]},"
              f" tokens/s {[round(tokens / w) for w in walls]} (global "
              f"batch), {[round(tokens / WORLD / w) for w in walls]} a "
              f"card; checkpoint saves blocked {r['saves']} s; losses "
              f"{r['losses']}; {_tag()}")
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    assert ranks[0]["latest"] == BF16_STEPS


@pytest.mark.gpu4
def test_full_width_step_memory_matches_the_dry_run(full_width):
    traced = full_width["traced_bytes"]
    assert isinstance(traced, int), traced
    for i, r in enumerate(full_width["ranks"]):
        card = r["bf16"]["peak_bytes"]
        print(f"\n(b) rank {i}: the first bf16 step's own peak "
              f"{card:,} bytes, the dry-run's trace {traced:,} "
              f"({traced / card:.4f}x, bar {MEMORY_RTOL} + "
              f"{MEMORY_ATOL:,} B)")
        assert abs(traced - card) <= MEMORY_RTOL * card + MEMORY_ATOL


@pytest.mark.gpu4
def test_elastic_restore_from_one_by_four_onto_two_by_two(full_width):
    ranks = [r["elastic"] for r in full_width["ranks"]]
    r0 = ranks[0]
    print(f"\n(c) restored onto (2, 2): losses {r0['losses_a']}; through "
          f"(1, 4) gathered whole: {r0['losses_b']}; one card: "
          f"{r0['losses_c']}")
    assert all(r["placed"] and r["identical"] for r in ranks), ranks
    assert r0["restore_exact"]
    assert all(abs(a - c) <= LOSS_RTOL * abs(c)
               for a, c in zip(r0["losses_a"], r0["losses_c"]))


@pytest.mark.gpu4
def test_compressed_reduce_over_nccl_equals_gloo(full_width):
    for r in full_width["ranks"]:
        got = r["compress"]
        print(f"\ncompressed_reduce NCCL vs gloo: {got}")
        assert got["int32_equal"] and got["ef_equal"], got

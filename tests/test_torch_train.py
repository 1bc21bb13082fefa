"""The port's training slice against the reference, on the CPU.

Inputs and parameters come from the reference (numpy in between): its
``init_params`` values converted with ``repro_torch.convert``, its data
stream's batches (which the port's stream reproduces bit for bit).

Tolerances, each with its reason:
* ``loss_fn`` and per-leaf gradients in fp32, all six families: the loss
  within 2e-6 relative, each gradient leaf within 1e-4 of its max|g|
  plus 1e-7 absolute (summation order; the key-bias gradients of
  attention without RoPE are zero in exact arithmetic and ~1e-9 noise
  in both frameworks, which the absolute term covers);
* the optimizer: lr exact but for the fp32 ``cos`` (one ulp), updated
  parameters within 1e-6 absolute after one step;
* three train steps from a converted state: parameters within 5e-5
  absolute (Adam's normalised step turns ulp-level gradient differences
  into lr-scaled ones), moments within 1e-4 of their max, metrics
  within 1e-5 relative;
* quantize: bit-equal; the data stream's tokens and labels bit-equal,
  its frame and patch stubs within 4 float32 ulps (XLA's ``log1p`` and
  ``erf_inv``, measured at 3);
* the port against itself (remat, microbatches, resume): bit-equal
  where the same operations run in the same order, the reference's own
  microbatch tolerance otherwise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.synthetic import SyntheticStream as JStream  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import compress as j_compress  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro.train import optim as j_optim  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_tree, train_state  # noqa: E402
from repro_torch.data.synthetic import SyntheticStream, make_batch  # noqa: E402
from repro_torch.models import forward, init_params, loss_fn  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    init_train_state,
    make_train_step,
)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.__main__ import main as train_main  # noqa: E402
from repro_torch.train.compress import (  # noqa: E402
    compressed_reduce,
    dequantize,
    quantize,
)
from repro_torch.train.loop import LoopConfig, train  # noqa: E402
from repro_torch.train.step import grads_of  # noqa: E402
from repro_torch.types import param_values, tree_leaves  # noqa: E402

FAMILIES = ["qwen2-0.5b", "mixtral-8x7b", "recurrentgemma-9b",
            "mamba2-130m", "whisper-tiny", "internvl2-26b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp32(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(jbatch) -> dict:
    """A reference batch as the port's: int64 tokens, fp32 stubs."""
    out = {k: _t(v) for k, v in jbatch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].to(torch.int64)
    return out


def _leaf_close(got, want, rtol=1e-4, atol=1e-7):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * float(np.abs(want).max(initial=0.0)) + atol, err


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference_fp32(arch):
    jcfg, tcfg = _fp32(arch)
    p = j_values(j_init(jax.random.PRNGKey(0), jcfg))
    batch = JStream(jcfg, 2, 16, seed=1).batch_at(0)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: j_loss_fn(p, batch, jcfg), has_aux=True)(p)
    grads, metrics = grads_of(model_tree(jax.tree.map(np.asarray, p),
                                         device="cpu"), _batch(batch), tcfg)
    assert float(metrics["loss"]) == pytest.approx(float(jloss), rel=2e-6)
    assert float(metrics["accuracy"]) == float(jm["accuracy"])
    want = jax.tree.leaves(jg)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _leaf_close(g, w)


def test_loss_fn_returns_loss_and_accuracy():
    cfg = get_smoke_config("qwen2-0.5b")
    params = param_values(init_params(0, cfg, device="cpu"))
    batch = make_batch(cfg, 2, 8, seed=0)
    loss, metrics = loss_fn(params, batch, cfg)
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert set(metrics) == {"loss", "accuracy"}
    assert 0.0 <= float(metrics["accuracy"]) <= 1.0


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_remat_gives_the_same_gradients(arch):
    """Layer-group remat recomputes the same operations: bit-equal."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = param_values(init_params(0, cfg, device="cpu"))
    batch = make_batch(cfg, 2, 16, seed=2)
    on = grads_of(params, batch, cfg)[0]
    off = grads_of(params, batch, dataclasses.replace(cfg, remat="none"))[0]
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_forward_rejects_an_unknown_mode():
    cfg = get_smoke_config("qwen2-0.5b")
    params = param_values(init_params(0, cfg, device="cpu"))
    with pytest.raises(ValueError, match="mode"):
        forward(params, make_batch(cfg, 1, 4), cfg, mode="eval")


# --------------------------------------------------------------------------
# the optimizer and the codec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 60, 120])
def test_lr_schedule_matches_reference(step):
    jc = JAdamW(lr=3e-3, warmup_steps=5, decay_steps=100)
    tc = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    want = np.float32(j_optim.lr_schedule(jc, jnp.int32(step)))
    got = optim.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 2 * float(np.spacing(want))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_adamw_update_match_reference(max_norm):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "b": rng.standard_normal((6,)).astype(np.float32),
              "blocks": ({"s": rng.standard_normal((2, 6)).astype(
                  np.float32)},)}
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.3)
                         .astype(np.float32), params)
    jc = JAdamW(lr=1e-2, grad_clip=max_norm, warmup_steps=2,
                decay_steps=20)
    tc = AdamWConfig(lr=1e-2, grad_clip=max_norm, warmup_steps=2,
                     decay_steps=20)
    jclip, jnorm = j_optim.clip_by_global_norm(grads, max_norm)
    tclip, tnorm = optim.clip_by_global_norm(model_tree(grads, device="cpu"),
                                             max_norm)
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    for g, w in zip(tree_leaves(tclip), jax.tree.leaves(jclip)):
        _leaf_close(g, w, 1e-6, 0.0)
    jopt = j_optim.adamw_init(params)
    topt = optim.adamw_init(model_tree(params, device="cpu"))
    tp = model_tree(params, device="cpu")
    for _ in range(3):       # bias corrections at counts 1, 2, 3
        params, jopt, jm = j_optim.adamw_update(jc, grads, jopt, params)
        tp, topt, tm = optim.adamw_update(tc, model_tree(grads, device="cpu"),
                                          topt, tp)
        for g, w in zip(tree_leaves(tp), jax.tree.leaves(params)):
            _leaf_close(g, w, 0.0, 1e-6)
        for g, w in zip(tree_leaves(topt), jax.tree.leaves(jopt)):
            _leaf_close(g, w, 1e-6, 0.0)
        assert topt["count"].dtype == torch.int32
    # weight decay only where ndim >= 2: the stacked norm scale is 2-D
    zero = {k: np.zeros_like(v) for k, v in params.items() if k != "blocks"}
    zero["blocks"] = ({"s": np.zeros((2, 6), np.float32)},)
    tp2, _, _ = optim.adamw_update(tc, model_tree(zero, device="cpu"),
                                   optim.adamw_init(tp), tp)
    assert torch.equal(tp2["b"], tp["b"])
    assert not torch.equal(tp2["blocks"][0]["s"], tp["blocks"][0]["s"])


def test_quantize_is_bit_equal_to_reference():
    rng = np.random.default_rng(7)
    for g in (rng.standard_normal((257, 33)).astype(np.float32) * 0.01,
              np.zeros((5,), np.float32),
              np.array([0.5, -1.5, 2.5, 127.0], np.float32)):
        jq, js = j_compress.quantize(jnp.asarray(g))
        tq, ts = quantize(_t(g))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        assert float(ts) == float(js)
        np.testing.assert_array_equal(dequantize(tq, ts).numpy(),
                                      np.asarray(j_compress.dequantize(jq, js)))


def test_compressed_reduce_error_feedback_matches_reference():
    rng = np.random.default_rng(1)
    jef = {"g": jnp.zeros((64,)), "h": jnp.zeros((3, 4))}
    tef = model_tree(jax.tree.map(np.asarray, jef), device="cpu")
    for _ in range(5):
        g = {"g": (rng.standard_normal(64) * 0.1).astype(np.float32),
             "h": rng.standard_normal((3, 4)).astype(np.float32)}
        jout, jef = j_compress.compressed_reduce(g, jef, axis="pod")
        tout, tef = compressed_reduce(model_tree(g, device="cpu"), tef,
                                      axis="pod")
        for got, want in ((tout, jout), (tef, jef)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # over a bound group of one rank the reduction is the round trip
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        gout, gef = compressed_reduce(tout, tef, axis="pod",
                                      group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    rout, ref_ef = compressed_reduce(tout, tef, axis="pod")
    for got, want in ((gout, rout), (gef, ref_ef)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the train step from a converted state
# --------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_steps_match_reference(microbatches):
    jcfg, tcfg = _fp32("qwen2-0.5b")
    jstate = j_init_state(j_values(j_init(jax.random.PRNGKey(0), jcfg)))
    tstate = train_state(jax.tree.map(np.asarray, jstate), device="cpu")
    jopt = JAdamW(lr=1e-3, warmup_steps=1, decay_steps=10)
    topt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(j_make_step(jcfg, jopt, microbatches=microbatches))
    tstep = make_train_step(tcfg, topt, microbatches=microbatches)
    jstream = JStream(jcfg, 4, 16, seed=3)
    tstream = SyntheticStream(tcfg, 4, 16, seed=3)
    for i in range(3):
        jstate, jm = jstep(jstate, jstream.batch_at(i))
        tstate, tm = tstep(tstate, tstream.batch_at(i))
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    assert int(tstate.step) == int(jstate.step) == 3
    for a, b in zip(tree_leaves(tstate.params), jax.tree.leaves(jstate.params)):
        _leaf_close(a, b, 0.0, 5e-5)
        assert a.requires_grad and a.grad is None
    for a, b in zip(tree_leaves(tstate.opt), jax.tree.leaves(jstate.opt)):
        _leaf_close(a, b, 1e-4, 0.0)


# --------------------------------------------------------------------------
# the data stream
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny",
                                  "internvl2-26b"])
@pytest.mark.parametrize("hosts", [(1, 0), (4, 1), (2, 1)])
def test_stream_is_the_references(arch, hosts):
    n, h = hosts
    want = JStream(j_smoke(arch), 8, 16, seed=5, num_hosts=n,
                   host_id=h).batch_at(3)
    got = SyntheticStream(get_smoke_config(arch), 8, 16, seed=5,
                          num_hosts=n, host_id=h).batch_at(3)
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape
        if k in ("tokens", "labels"):
            np.testing.assert_array_equal(g, w)
        else:
            ulps = np.abs(g.view(np.int32).astype(np.int64)
                          - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= 4, ulps.max()


# --------------------------------------------------------------------------
# twins of tests/test_training.py
# --------------------------------------------------------------------------
def _setup(arch="qwen2-0.5b"):
    cfg = get_smoke_config(arch)
    return cfg, param_values(init_params(0, cfg, device="cpu"))


def _learns(state, step_fn, cfg):
    stream = SyntheticStream(cfg, 4, 32, seed=0)
    losses = []
    for i in range(30):
        state, m = step_fn(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return np.mean(losses[:5]), np.mean(losses[-5:])


def test_loss_decreases():
    cfg, params = _setup()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    first, last = _learns(init_train_state(params),
                          make_train_step(cfg, opt), cfg)
    assert last < first - 0.25, f"no learning: {first:.3f} -> {last:.3f}"


def test_microbatch_equivalence():
    """Grad accumulation over 2 microbatches == single-shot (the
    reference test's tolerance)."""
    cfg, params = _setup()
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, decay_steps=10)
    batch = make_batch(cfg, 4, 32, seed=3)
    s1, _ = make_train_step(cfg, opt, microbatches=1)(
        init_train_state(params), batch)
    s2, _ = make_train_step(cfg, opt, microbatches=2)(
        init_train_state(params), batch)
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   c.detach().float().numpy(),
                                   rtol=5e-2, atol=5e-3)


def test_train_step_frees_its_tensors_without_the_cyclic_collector():
    """A training step leaves no tensor in a reference cycle: with the
    cyclic collector off, every tensor of the state it took and the
    state and metrics it returned dies by reference counting at ``del``,
    and a collection afterwards finds no tensor among the step's
    unreachable objects (a step that left ~10 GB of qwen2-0.5b's tensors
    to the collector, through ``types.tree_flatten``'s recursive
    closure, failed both)."""
    import gc
    import weakref

    cfg, params = _setup()
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                               decay_steps=10))
    batch = make_batch(cfg, 4, 32, seed=3)
    state, _ = step_fn(init_train_state(params), batch)
    del params
    gc.collect()
    flags = gc.get_debug()
    gc.disable()
    try:
        new_state, metrics = step_fn(state, batch)
        tensors = [*tree_leaves(state.params), *tree_leaves(state.opt),
                   *tree_leaves(new_state.params),
                   *tree_leaves(new_state.opt), new_state.step,
                   *metrics.values()]
        assert all(isinstance(t, torch.Tensor) for t in tensors)
        refs = [weakref.ref(t) for t in tensors]
        del state, new_state, metrics, tensors
        alive = sum(r() is not None for r in refs)
        assert alive == 0, f"{alive} of {len(refs)} tensors outlive del"
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        assert not cyclic, f"{len(cyclic)} tensors in reference cycles"
    finally:
        gc.garbage.clear()
        gc.set_debug(flags)
        gc.enable()


def test_quantize_roundtrip_error_bound():
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (257, 33)).astype(np.float32) * 0.01)
    q, scale = quantize(g)
    err = (dequantize(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-9


def test_error_feedback_accumulates():
    """With EF, the *sum* of compressed grads tracks the sum of true grads."""
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(64)
    comp_sum = torch.zeros(64)
    ef = {"g": torch.zeros(64)}
    for _ in range(50):
        g = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(
            np.float32))
        out, ef = compressed_reduce({"g": g}, ef, axis="pod")
        true_sum += g
        comp_sum += out["g"]
    assert float((comp_sum - true_sum).abs().max()) < 0.05


def test_compressed_training_still_learns():
    cfg, params = _setup()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    first, last = _learns(init_train_state(params, compress=True),
                          make_train_step(cfg, opt, compress_axis="pod"), cfg)
    assert last < first - 0.25


def test_data_stream_host_sharding_consistent():
    cfg = get_smoke_config("qwen2-0.5b")
    full = SyntheticStream(cfg, 8, 16, seed=5).batch_at(3)
    parts = [SyntheticStream(cfg, 8, 16, seed=5, num_hosts=4,
                             host_id=h).batch_at(3) for h in range(4)]
    assert torch.equal(full["tokens"],
                       torch.cat([p["tokens"] for p in parts]))


# --------------------------------------------------------------------------
# the loop and the CLI
# --------------------------------------------------------------------------
def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """A failure at step 6 restores step 4 and replays steps 4 and 5:
    every loss, and the final state, bit-equal to an unbroken run."""
    cfg = get_smoke_config("qwen2-0.5b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    armed = [True]

    def failure_hook(step):
        if step == 6 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure at step 6")

    def run(name, hook, every):
        loop_cfg = LoopConfig(total_steps=12, checkpoint_every=every,
                              checkpoint_dir=str(tmp_path / name),
                              async_save=True, log_every=100)
        return train(cfg, opt, loop_cfg, global_batch=2, seq_len=16,
                     failure_hook=hook, log=lambda s: None, device="cpu")

    broken = run("broken", failure_hook, 4)
    whole = run("whole", None, 100)
    assert broken.restarts == 1 and whole.restarts == 0
    assert len(broken.losses) == 14
    assert broken.losses[:6] == whole.losses[:6]
    assert broken.losses[6:] == whole.losses[4:]
    for a, b in zip(tree_leaves(broken.state), tree_leaves(whole.state)):
        assert torch.equal(a, b)


def test_train_cli_runs_on_cpu(tmp_path, capsys):
    train_main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "after 4 steps" in out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_runs_through_the_kernels_on_card(monkeypatch):
    """bf16 smoke step: the backward kernel once a layer, and the loss
    and every gradient leaf within chip_smoke.py's bf16 tolerances of
    the same step through the plain attention and autograd."""
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.kernels.swa import ops as swa_ops

    dev = _card()
    cfg = get_smoke_config("qwen2-0.5b")
    params = param_values(init_params(0, cfg, device=dev))
    batch = make_batch(cfg, 4, 64, seed=1, device=dev)
    before = swa_kernel.bwd_launches
    g_k, m_k = grads_of(params, batch, cfg)
    assert swa_kernel.bwd_launches == before + cfg.num_layers
    monkeypatch.setattr(swa_ops, "swa_attention",
                        lambda q, k, v, **kw: swa_ops.swa_attention_plain(
                            q, k, v, **kw))
    g_p, m_p = grads_of(params, batch, cfg)
    assert float(m_k["loss"]) == pytest.approx(float(m_p["loss"]), rel=1e-2)
    for a, c in zip(tree_leaves(g_k), tree_leaves(g_p)):
        rel = float((a.float() - c.float()).norm()
                    / c.float().norm().clamp_min(1e-30))
        assert rel <= 5e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_resumed_run_equals_an_unbroken_one_on_card(tmp_path, arch):
    """Through the swa or the ssd forward and backward kernels: no
    atomics, so the resumed losses and final state equal an unbroken
    run's bit for bit."""
    dev = _card()
    cfg = get_smoke_config(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, decay_steps=50)
    armed = [True]

    def failure_hook(step):
        if step == 6 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure at step 6")

    def run(name, hook, every):
        loop_cfg = LoopConfig(total_steps=12, checkpoint_every=every,
                              checkpoint_dir=str(tmp_path / name),
                              log_every=100)
        return train(cfg, opt, loop_cfg, global_batch=2, seq_len=64,
                     failure_hook=hook, log=lambda s: None, device=dev)

    broken = run("broken", failure_hook, 4)
    whole = run("whole", None, 100)
    assert broken.losses[6:] == whole.losses[4:]
    for a, b in zip(tree_leaves(broken.state), tree_leaves(whole.state)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_train_cli_runs_on_card(tmp_path, capsys):
    _card()
    train_main(["--steps", "4", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device=cuda" in out and "after 4 steps" in out

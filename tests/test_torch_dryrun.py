"""The port's dry-run end to end: cells through the real entry point
(``python -m repro_torch.launch.dryrun``) in subprocesses, since a cell
starts a placeholder process group of 256 ranks, checked as
tests/test_dryrun.py checks the reference's artifact; the split-K
preset of grok-1-314b's decode cell against its baseline; the memory
analysis (``step_memory``) on a hand-built step, on a cell, on the
kernels' meta routes against the buffers their card wrappers allocate,
and on the card against the caching allocator."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.dryrun import step_memory  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"arch", "shape", "mesh", "mode", "rule_overrides", "n_devices",
        "dropped_axes", "memory", "cost", "roofline", "model_flops",
        "model_flops_ratio"}


def _run(tmp_path, *args) -> None:
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", ""), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--mesh", "pod", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=400, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]


def _cell(path: pathlib.Path) -> dict:
    out = json.loads(path.read_text())
    assert "error" not in out
    assert KEYS <= set(out)
    assert out["n_devices"] == 256
    assert out["cost"]["flops"] > 0
    return out


def test_dryrun_cell_end_to_end(tmp_path):
    _run(tmp_path, "--arch", "whisper-tiny", "--shape", "decode_32k")
    out = _cell(tmp_path / "pod" / "whisper-tiny__decode_32k.json")
    r = out["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert set(r) >= {"dominant", "roofline_fraction", "collective_s"}
    assert out["memory"]["argument_bytes"] > 0
    assert out["memory"]["output_bytes"] > 0
    assert out["memory"]["temp_bytes"] > 0
    assert out["memory"]["alias_bytes"] == 0    # the select writes anew
    # whisper's 6 heads decline the 16-way model axis
    assert "('heads', 'model', 6)" in out["dropped_axes"]
    assert sum(out["cost"]["coll_counts"].values()) > 0


def test_grok_decode_preset_shards_the_cache_without_gathering_it(tmp_path):
    """int8 KV and cache_seq -> model: less argument memory a device, the
    split-K combine's all-reduces, and no collective as large as one
    layer's cache gathered over the sequence shards."""
    _run(tmp_path / "base", "--arch", "grok-1-314b", "--shape",
         "decode_32k")
    _run(tmp_path / "perf", "--perf", "--arch", "grok-1-314b", "--shape",
         "decode_32k")
    name = "grok-1-314b__decode_32k.json"
    base = _cell(tmp_path / "base" / "pod" / name)
    perf = _cell(tmp_path / "perf" / "pod" / name)
    assert perf["rule_overrides"] == {"cache_seq": ["model"]}
    assert perf["memory"]["argument_bytes"] \
        < base["memory"]["argument_bytes"]
    # grok decode_32k: 128 rows over 16 data shards, 32768 positions,
    # 8 KV heads of 128, int8: one layer's K gathered over the sequence
    one_layer_cache = 128 // 16 * 32768 * 8 * 128
    assert perf["cost"]["largest_collective"]["result_bytes"] \
        < one_layer_cache
    assert perf["cost"]["coll_counts"]["all-reduce"] \
        > base["cost"]["coll_counts"]["all-reduce"]


# --------------------------------------------------------------------------
# the memory analysis: live storages in the allocator's 512-byte blocks
# --------------------------------------------------------------------------
def test_step_memory_counts_a_hand_built_step():
    """A freed intermediate, a view counted once, an in-place result on
    an input counted as alias, 512-byte blocks."""
    x = torch.empty(1000, device="meta")                 # 4,000 bytes

    def step(x):
        a = x * 2              # 4,096 live
        b = a[10:]             # a view: nothing
        c = a + 1              # 8,192 live: the peak
        del a, b               # 4,096 live
        c.add_(1)              # in place: nothing
        d = torch.empty(3, device="meta")    # 12 bytes in one block
        x.mul_(2)              # in place on an input: nothing
        return c, x, d

    (c, x_out, d), memory = step_memory(step, x)
    assert x_out is x
    assert memory == {"argument_bytes": 4000, "output_bytes": 8012,
                      "alias_bytes": 4000, "peak_bytes": 4000 + 8192,
                      "temp_bytes": 4000 + 8192 - 4000 - 8012 + 4000}


def test_dryrun_cell_memory_closes_the_reference_identity(tmp_path):
    """whisper-tiny x decode_32k x pod (tests/test_dryrun.py's cell):
    the record's four keys are step_memory's, ``temp_bytes > 0``, and
    arguments + outputs + temp - alias is the traced peak exactly."""
    script = (
        "import json\n"
        "from repro_torch.launch import dryrun\n"
        "seen, trace = [], dryrun.step_memory\n"
        "def traced(fn, *args):\n"
        "    result, memory = trace(fn, *args)\n"
        "    seen.append(memory)\n"
        "    return result, memory\n"
        "dryrun.step_memory = traced\n"
        "out = dryrun.run_cell('whisper-tiny', 'decode_32k', False)\n"
        "print(json.dumps({'record': out['memory'], 'traced': seen}))\n")
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", ""), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=400,
                          env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    record, (traced,) = got["record"], got["traced"]
    assert set(record) == {"argument_bytes", "output_bytes", "temp_bytes",
                           "alias_bytes"}
    assert record == {k: traced[k] for k in record}
    assert record["temp_bytes"] > 0
    assert record["argument_bytes"] + record["output_bytes"] \
        + record["temp_bytes"] - record["alias_bytes"] == traced["peak_bytes"]


def _blocks(nbytes: int) -> int:
    return -(-nbytes // 512) * 512


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tc"), (torch.float32, 64, "fma"),
    (torch.bfloat16, 256, "fma")])
@pytest.mark.parametrize("strided_kv", [False, True])
def test_swa_meta_route_allocates_the_card_wrappers_buffers(dtype, d, route,
                                                             strided_kv):
    """The forward: its output, the fp32 (B, Hq, S) lse saved for the
    tensor-core backward, and a copy of each strided k/v as the card's
    ``.contiguous()`` makes; the backward: the three gradients and the
    card wrapper's fp32 scratch by route (tc: stats (B, Hq, S padded to
    64, 2) and part (2, B, S, Hq, D); fma: lse_s and delta (B, Hq, S))."""
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops

    b, s, hq, hkv, size = 2, 100, 4, 2, torch.empty((), dtype=dtype).itemsize
    assert K.bwd_route(dtype, d) == route
    q = _meta(b, s, hq, d, dtype=dtype, grad=True)
    if strided_kv:     # k and v as halves of one (B, S, 2 Hkv, D) tensor
        kv = _meta(b, s, 2 * hkv, d, dtype=dtype, grad=True)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]
    else:
        k, v = (_meta(b, s, hkv, d, dtype=dtype, grad=True) for _ in "kv")
    o, fwd = step_memory(
        lambda q, k, v: ops.swa_attention(q, k, v, window=s), q, k, v)
    lse = 4 * b * hq * s if route == "tc" else 0
    copies = 2 * _blocks(b * s * hkv * d * size) if strided_kv else 0
    assert fwd["peak_bytes"] - fwd["argument_bytes"] \
        == copies + _blocks(o.numel() * size) + _blocks(lse)
    assert fwd["temp_bytes"] == copies + _blocks(lse)

    do = _meta(b, s, hq, d, dtype=dtype)
    _, bwd = step_memory(lambda q, k, v, o, do: torch.autograd.grad(
        o, (q, k, v), do), q, k, v, o, do)
    scratch = [4 * b * hq * (-(-s // 64) * 64) * 2, 4 * 2 * b * s * hq * d] \
        if route == "tc" else [4 * b * hq * s] * 2
    grads = _blocks(q.numel() * size) + 2 * _blocks(k.numel() * size)
    assert bwd["peak_bytes"] - bwd["argument_bytes"] \
        == copies + grads + sum(map(_blocks, scratch))
    assert bwd["temp_bytes"] == copies + sum(map(_blocks, scratch))


@pytest.mark.parametrize("misaligned", [False, True])
def test_ssd_meta_route_allocates_the_card_wrappers_buffers(misaligned):
    """The forward: y and the states; the backward: the five gradients
    and the card wrapper's fp32 scratch (C.B^T (cells, qp, qp), gCB's
    head-group partials (cells, groups, qp, qp), the row and column
    partials (cells, tiles, h, q) and r (cells, h, q)); an operand off
    the 16-byte alignment copied as the card's ``_aligned`` copies it."""
    from repro_torch.kernels.ssd import ops

    bb, nc, q, h, p, n = 2, 3, 100, 10, 32, 16    # q pads to 128 (2 tiles)
    cells, qp, tiles, groups = bb * nc, 128, 2, 2     # 10 heads in 8s: 2
    x = _meta(bb, nc, q, h, p, grad=True)
    dt, cum = (_meta(bb, nc, q, h, grad=True) for _ in "dc")
    B, C = (_meta(bb, nc, q, n, grad=True) for _ in "BC")
    y, states = ops._SsdIntraChunk.apply(x, dt, cum, B, C, "meta")
    assert states.shape == (bb, nc, h, n, p)
    gy = _meta(x.numel() + 1)[1:].view(x.shape) if misaligned \
        else _meta(*x.shape)
    gst = _meta(*states.shape)
    _, bwd = step_memory(lambda *a: torch.autograd.grad(
        (y, states), a[:5], a[5:]), x, dt, cum, B, C, gy, gst)
    scratch = [cells * qp * qp, cells * groups * qp * qp,
               cells * tiles * h * q, cells * tiles * h * q, cells * h * q]
    copy = _blocks(4 * gy.numel()) if misaligned else 0
    grads = [4 * t.numel() for t in (x, dt, cum, B, C)]
    assert bwd["output_bytes"] == sum(grads)
    assert bwd["peak_bytes"] - bwd["argument_bytes"] \
        == copy + sum(map(_blocks, grads)) + sum(_blocks(4 * e)
                                                  for e in scratch)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_traced_step_memory_is_the_allocators_on_card(arch):
    """A bf16 training step of the smoke config at 4 x 512 through the
    swa or ssd kernels and their backward: the bytes the caching
    allocator held at once inside the step against step_memory's trace
    of the same step on meta tensors (the warm-up step allocates the
    cuBLAS workspace first; the garbage it leaves in reference cycles is
    collected before the bracket, not inside it)."""
    import gc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.models import init_params
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.types import param_values

    cfg = get_smoke_config(arch)
    step_fn = make_train_step(cfg, AdamWConfig())
    stream = SyntheticStream(cfg, 4, 512, seed=0, device="cuda")
    state = init_train_state(param_values(init_params(0, cfg,
                                                      device="cuda")))
    state, _ = step_fn(state, stream.batch_at(0))
    batch = stream.batch_at(1)
    launched = swa_kernel.bwd_launches + ssd_kernel.bwd_launches
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_fn(state, batch)
    card = torch.cuda.max_memory_allocated() - base
    assert swa_kernel.bwd_launches + ssd_kernel.bwd_launches \
        == launched + cfg.num_layers
    meta_state = init_train_state(param_values(init_params(
        0, cfg, device="meta")))
    _, memory = step_memory(step_fn, meta_state, {
        k: torch.empty_like(v, device="meta") for k, v in batch.items()})
    traced = memory["peak_bytes"] - memory["argument_bytes"]
    assert abs(traced - card) <= 0.03 * card + 2**20, (traced, card)

"""The port's serving slice against the reference, on the CPU.

The oracle's prefill, decode and mixed steps give the reference's
``LaneMetrics`` records exactly, and a smoke-config ``ServeEngine`` run
in fp32 at temperature 0 gives the reference engine's tokens, step log
and ``EngineStats`` exactly (the simulator pieces underneath are held
bit for bit in tests/test_torch_serve_sim.py).  The deprecated
``generate()`` shim gives the reference shim's tokens and lengths and
warns at the caller's line; ``checkpoint``/``restore`` resume a run bit
for bit and refuse a snapshot of another configuration."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import cache as j_cache  # noqa: E402
from repro.models import decode_working_set as j_ws  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serve import PagedKVCache as JKV  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import SoCLatencyOracle as JOracle  # noqa: E402
from repro.types import param_values as j_values  # noqa: E402
from repro.utils import stats as j_stats  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import model_tree  # noqa: E402
from repro_torch.core import cache as t_cache  # noqa: E402
from repro_torch.models import decode_working_set as t_ws  # noqa: E402
from repro_torch.serve import PagedKVCache as TKV  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import SoCLatencyOracle as TOracle  # noqa: E402
from repro_torch.serve.__main__ import main as serve_main  # noqa: E402
from repro_torch.types import tree_leaves  # noqa: E402
from repro_torch.utils import stats as t_stats  # noqa: E402

ARCH = "mamba2-130m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracles(weight_bytes, llc_bytes):
    jo = JOracle(j_ws(j_get(ARCH)), weight_bytes=weight_bytes,
                 llc=j_cache.LLCConfig(llc_bytes, 8, 64))
    to = TOracle(t_ws(get_config(ARCH)), weight_bytes=weight_bytes,
                 llc=t_cache.LLCConfig(llc_bytes, 8, 64), device="cpu")
    kj = JKV(num_blocks=140, block_size=16, token_bytes=1)
    kt = TKV(num_blocks=140, block_size=16, token_bytes=1)
    for rid in range(4):
        kj.admit(rid, 512, 32)
        kt.admit(rid, 512, 32)
    return jo, to, kj, kt


def test_oracle_prefill_decode_and_mixed_steps_match_reference():
    """The mamba2-130m working set (fp32 SSM state of 19 MB per slot)
    with its weight stream cut to 1 MiB and a 128 KiB LLC, so the
    replay stays small on the CPU; the card runs the full size."""
    jo, to, kj, kt = _oracles(1 << 20, 128 << 10)
    for step in (lambda o, k: o.prefill_step(k, [0, 1]),
                 lambda o, k: o.decode_step(k, [0, 1, 2, 3]),
                 lambda o, k: o.prefill_step(k, [2], decode_rids=[0, 1])):
        got, want = step(to, kt), step(jo, kj)
        assert got.metrics.to_record() == want.metrics.to_record()
        assert (got.cycles, got.seconds) == (want.cycles, want.seconds)
    assert len(to._memo) == 3
    to.decode_step(kt, [0, 1, 2, 3])
    assert len(to._memo) == 3                 # memoized by trace


def test_oracle_backends():
    from repro_torch.core import npu as t_npu

    ws = t_ws(get_config(ARCH))
    o = TOracle(ws, backend="npu", device="cpu")
    assert o.backend == "npu" and o.npu == t_npu.NPUConfig()
    jo = JOracle(j_ws(j_get(ARCH)), backend="npu")
    for slots in (1, 4):
        assert [dataclasses.astuple(s) for s in o._weight_segments(slots)] \
            == [dataclasses.astuple(s) for s in jo._weight_segments(slots)]
    with pytest.raises(ValueError, match="only applies"):
        TOracle(ws, npu=t_npu.NPUConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        TOracle(ws, backend="tpu", device="cpu")


def test_stats_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 57, 200):
        vals = rng.standard_normal(n).tolist()
        assert t_stats.latency_summary(vals) == \
            j_stats.latency_summary(vals)
        for q in (0, 33.35, 50, 99, 100):
            assert t_stats.nearest_rank(sorted(vals), q) == \
                j_stats.nearest_rank(sorted(vals), q)


def test_engine_matches_reference_engine_fp32():
    """Smoke config in fp32, temperature 0, prompts of 24 / 64 / 40
    tokens (one chunk, two chunks, a ragged chunk), more requests than
    slots: identical tokens, step log and stats."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = j_values(j_init(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(cache_len=80, max_slots=3, eos_id=-1, temperature=0.0)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(7):
        plen = (24, 64, 40)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6))
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6))
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    assert {r.kind for r in teng.step_log} >= {"prefill", "decode",
                                               "mixed"}
    assert teng.wall_s["model"] > 0 and teng.wall_s["oracle"] > 0


def test_engine_matches_reference_engine_at_temperature():
    """Sampling at temperature 0.8 with an EOS (148, which the seed-5
    draws hit early in two requests): the port draws with the
    reference's keys, ``fold_in(fold_in(PRNGKey(seed), rid), n)``, and
    its Gumbel-max (``repro_torch.utils.prng``), so the tokens, the
    retire times and the step log are the reference engine's."""
    jcfg = dataclasses.replace(j_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = j_values(j_init(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(cache_len=80, max_slots=3, eos_id=148, temperature=0.8,
              seed=5)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(7):
        plen = (24, 64, 40)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6))
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6))
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    early = [f for f in teng.finished if f["tokens"][-1] == 148
             and len(f["tokens"]) < 6 + f["rid"]]
    assert len(early) >= 2


def test_hybrid_engine_matches_reference_engine_fp32():
    """recurrentgemma-9b's smoke config (window 16) in fp32, temperature
    0: prompts of 24, 12 and 30 tokens (past the window, inside it,
    ragged), attention caches of 16 slots rolling over during decode,
    more requests than slots — identical tokens, step log and stats."""
    arch = "recurrentgemma-9b"
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = j_values(j_init(jax.random.PRNGKey(0), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    kw = dict(cache_len=48, max_slots=3, eos_id=-1, temperature=0.0)
    jeng = JEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rng = np.random.default_rng(1)
    for i in range(5):
        plen = (24, 12, 30)[i % 3]
        toks = tuple(int(t) for t in rng.integers(3, tcfg.vocab_size, plen))
        jeng.submit(JRequest(rid=i, tokens=toks, max_new=6 + i,
                             arrival_s=i * 2e-6))
        teng.submit(Request(rid=i, tokens=toks, max_new=6 + i,
                            arrival_s=i * 2e-6))
    want, got = jeng.run(), teng.run()
    assert got.to_record() == want.to_record()
    assert [r.to_record() for r in teng.step_log] == \
        [r.to_record() for r in jeng.step_log]
    assert teng.finished == jeng.finished
    assert {r.kind for r in teng.step_log} >= {"prefill", "decode",
                                               "mixed"}


def test_full_width_working_sets_match_reference():
    """The byte model the oracle lowers, at full width, field for field
    (recurrentgemma-9b's 19 GB weight stream is why its serving run
    models a resident subset with ``weight_bytes=``)."""
    for arch in ("mamba2-130m", "recurrentgemma-9b"):
        assert dataclasses.asdict(t_ws(get_config(arch))) == \
            dataclasses.asdict(j_ws(j_get(arch)))
    ws = t_ws(get_config("recurrentgemma-9b"))
    assert (ws.weight_bytes, ws.state_bytes, ws.kv_token_bytes) == \
        (19_145_129_984, 1_064_960, 12_288)
    assert ws.kv_entries == ((2048, 1024),) * 12
    with pytest.raises(ValueError, match="weight_bytes="):
        TOracle(ws, device="cpu")


def test_engine_samples_from_a_seeded_generator():
    cfg = get_smoke_config(ARCH)
    from repro_torch.models import init_params
    from repro_torch.types import param_values

    params = param_values(init_params(0, cfg, device="cpu"))
    runs = []
    for _ in range(2):
        eng = ServeEngine(cfg, params, cache_len=40, max_slots=2,
                          eos_id=-1, temperature=0.8, seed=3, device="cpu")
        for i in range(3):
            eng.submit(Request(rid=i, tokens=(5, 6, 7, 8 + i), max_new=5))
        eng.run()
        runs.append([f["tokens"] for f in eng.finished])
    assert runs[0] == runs[1]
    assert all(0 <= t < cfg.vocab_size for r in runs[0] for t in r)


def test_serve_cli_runs_on_cpu(capsys):
    serve_main(["--device", "cpu", "--requests", "3", "--prompt-len", "8",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke  device=cpu" in out
    assert "simulated SoC:" in out


def test_serve_cli_runs_the_hybrid_on_cpu(capsys):
    serve_main(["--arch", "recurrentgemma-9b", "--device", "cpu",
                "--requests", "3", "--prompt-len", "20", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-smoke  device=cpu" in out
    assert "simulated SoC:" in out


# --------------------------------------------------------------------------
# the deprecated generate() shim and checkpoint/restore (twins of
# tests/test_serve.py), fp32 smoke configs against the reference engine
# --------------------------------------------------------------------------
def _engines(arch, seed=0, **kw):
    jcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = j_values(j_init(jax.random.PRNGKey(seed), jcfg))
    tparams = model_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return (JEngine(jcfg, jparams, **kw),
            ServeEngine(tcfg, tparams, device="cpu", **kw), jcfg)


def _generate_both(arch, n, max_new, seed=0, batch_seed=0, **kw):
    from repro.data.synthetic import make_batch as j_make_batch

    jeng, teng, jcfg = _engines(arch, seed, **kw)
    batch = j_make_batch(jcfg, n, 16, seed=batch_seed)
    batch.pop("labels")
    batch = {k: np.asarray(v) for k, v in batch.items()}
    with pytest.warns(DeprecationWarning, match="deprecated"):
        want = jeng.generate(batch, max_new=max_new)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = teng.generate(batch, max_new=max_new)
    return got, want


def test_generate_shim_matches_reference():
    got, want = _generate_both("qwen2-0.5b", 3, 8, cache_len=64, eos_id=0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.steps == want.steps


def test_generate_shim_parity_with_queueing():
    """max_slots below the batch size queues the shim's requests."""
    got, want = _generate_both("qwen2-0.5b", 4, 6, batch_seed=2,
                               cache_len=64, max_slots=2, eos_id=0)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "whisper-tiny"])
def test_generate_hybrid_ssm_and_encoder_decoder(arch):
    """Across cache families (SSM state, recurrent hybrid, whisper's
    frames through the extras path)."""
    got, want = _generate_both(arch, 2, 4, seed=1, batch_seed=1,
                               cache_len=64, eos_id=0)
    assert got.tokens.shape[0] == 2
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_generate_shim_warns_at_the_callers_line():
    import warnings

    _, teng, _ = _engines("qwen2-0.5b", cache_len=16, max_slots=2,
                          eos_id=0)
    batch = {"tokens": np.full((1, 4), 3, np.int64)}
    fn = lambda: teng.generate(batch, 2)  # noqa: E731
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        fn()
    deps = [w for w in log if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1
    assert deps[0].filename == __file__
    assert deps[0].lineno == fn.__code__.co_firstlineno


def _trace_requests(cfg, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=tuple(int(x) for x in
                                        rng.integers(3, cfg.vocab_size, 12)),
                    max_new=6, arrival_s=i * 2e-5) for i in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_restore_resumes_bit_identical(dtype):
    """Snapshot after 5 steps, restore into a fresh engine: the same
    tokens, cycles and stats as an unbroken run; in bf16 the caches
    round-trip as host tensors of their own dtype."""
    from repro_torch.models import init_params
    from repro_torch.types import param_values

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), dtype=dtype)
    params = param_values(init_params(0, cfg, device="cpu"))
    kw = dict(cache_len=32, max_slots=2, eos_id=0, device="cpu")

    def engine():
        return ServeEngine(cfg, params, **kw)

    ref = engine()
    for r in _trace_requests(cfg):
        ref.submit(r)
    ref.run()
    eng = engine()
    for r in _trace_requests(cfg):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    snap = eng.checkpoint()
    assert any(t.dtype == getattr(torch, dtype) and t.device.type == "cpu"
               for t in tree_leaves(snap["caches"]))
    fresh = engine()
    fresh.restore(snap)
    while fresh.queue or fresh._active_slot_ids():
        fresh.step()
    assert [f["tokens"] for f in fresh.finished] == \
        [f["tokens"] for f in ref.finished]
    assert [r.cycles for r in fresh.step_log] == \
        [r.cycles for r in ref.step_log[5:]]
    assert fresh.stats() == ref.stats()
    # the snapshot is unchanged by the resumed run: restoring it again
    # resumes again
    again = engine()
    again.restore(snap)
    again.run()
    assert again.finished == fresh.finished


def test_restore_rejects_mismatched_config():
    from repro_torch.models import init_params
    from repro_torch.types import param_values

    cfg = get_smoke_config("qwen2-0.5b")
    params = param_values(init_params(0, cfg, device="cpu"))
    eng = ServeEngine(cfg, params, cache_len=32, eos_id=0, device="cpu")
    eng.submit(Request(rid=0, tokens=(3, 4, 5), max_new=2))
    snap = eng.checkpoint()
    other = ServeEngine(cfg, params, cache_len=64, eos_id=0, device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        other.restore(snap)

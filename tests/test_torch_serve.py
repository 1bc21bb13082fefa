"""The port's serving slice against the reference, on the CPU.

The oracle's prefill, decode and mixed steps give the reference's
``LaneMetrics`` records exactly, and a smoke-config ``ServeEngine`` run
in fp32 at temperature 0 gives the reference engine's tokens, step log
and ``EngineStats`` exactly (the simulator pieces underneath are held
bit for bit in tests/test_torch_serve_sim.py)."""
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
    ws = t_ws(get_config(ARCH))
    with pytest.raises(NotImplementedError, match="core/npu"):
        TOracle(ws, backend="npu", device="cpu")
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

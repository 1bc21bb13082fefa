"""The port's campaign run farm against the reference, on the CPU.

The same specs through ``repro.campaign`` and ``repro_torch.campaign``
expand to the same ``point_id``s and ``spec_hash``es, refuse the same
bad specs, and write byte-identical ``journal.jsonl`` and
``manifest.json`` files; the port's executor survives injected crashes,
hangs, NaNs, corruptions and torn writes and resumes to the clean run's
bytes, sequentially, batched and over a mesh of CPU devices.

Timeouts here are seconds, not fractions of one: a point of these specs
runs in ~10 ms on one core, and the tests must pass with the host
loaded by 6 workers, so a hang test gives each attempt 4 s and hangs
for 8."""
from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import pathlib

import pytest

torch = pytest.importorskip("torch")

import repro.campaign as J  # noqa: E402
import repro.campaign.spec as j_spec  # noqa: E402
import repro_torch.campaign as T  # noqa: E402
import repro_torch.campaign.spec as t_spec  # noqa: E402
from repro_torch.campaign import cli as t_cli  # noqa: E402
from repro_torch.campaign.manifest import record_crc  # noqa: E402
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S, HANG_S = 4.0, 8.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def specs(pkg, name):
    """The same spec built by either package."""
    if name == "example":
        return pkg.example_spec(4, window_bursts=256)
    if name == "example6":
        return pkg.example_spec(6, window_bursts=256)
    if name == "mixed":
        return pkg.mixed_backend_spec(4, window_bursts=128)
    if pkg is T:
        return chip_smoke().acceptance_spec(16, 256)
    from benchmarks.campaign_bench import _acceptance_spec

    return _acceptance_spec(16, 256)


def tiny():
    return specs(T, "example")


def read(out, name="manifest.json") -> bytes:
    return (pathlib.Path(out) / name).read_bytes()


def run(spec, out, **kw):
    return T.run_campaign(spec, str(out), device=CPU, **kw)


def until_done(spec, out, plan, policy, **kw):
    """Rerun with resume after every simulated process death."""
    runs = 0
    while True:
        runs += 1
        assert runs < 12, "campaign did not converge"
        try:
            return run(spec, out, resume=runs > 1, policy=policy,
                       hooks=T.FaultInjector(plan, str(out)), **kw), runs
        except T.InjectedCrash:
            continue


# --------------------------------------------------------------------------
# specs: ids, hashes and refusals equal the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["example", "example6", "mixed",
                                  "acceptance"])
def test_point_ids_and_spec_hash_match_reference(name, tmp_path):
    js, ts = specs(J, name), specs(T, name)
    assert ts.to_dict() == js.to_dict()
    assert ts.spec_hash == js.spec_hash
    assert [p.point_id for p in ts.expand()] == \
        [p.point_id for p in js.expand()]
    assert [p.params() for p in ts.expand()] == \
        [p.params() for p in js.expand()]
    ts.save(str(tmp_path / "t.json"))
    js.save(str(tmp_path / "j.json"))
    assert read(tmp_path, "t.json") == read(tmp_path, "j.json")
    assert T.CampaignSpec.load(str(tmp_path / "j.json")) == ts


def test_geometry_and_trace_sources_match_reference():
    for kw in ({"size_kib": 2048}, {"size_kib": 8, "block": 128},
               {"size_kib": 4, "ways": 2}):
        assert t_spec.GeometrySpec(**kw).llc().__dict__ == \
            j_spec.GeometrySpec(**kw).llc().__dict__
    for kw in ({"window_bursts": 256}, {"window_bursts": 128,
                                        "backend": "npu", "npu_rows": 8,
                                        "npu_cols": 8},
               {"window_bursts": 64, "name": "mamba2_decode",
                "backend": "npu"}):
        got = [(s.base, s.stride, s.count, s.stream)
               for s in t_spec.ModelSpec(**kw).trace()]
        want = [(s.base, s.stride, s.count, s.stream)
                for s in j_spec.ModelSpec(**kw).trace()]
        assert got == want


BAD_SPECS = {
    "wss": lambda p: p.MixSpec(1, "l2"),
    "corunners": lambda p: p.MixSpec(-1),
    "model": lambda p: p.ModelSpec(name="resnet"),
    "window": lambda p: p.ModelSpec(window_bursts=0),
    "backend": lambda p: p.ModelSpec(backend="tpu"),
    "trace_source": lambda p: p.ModelSpec(name="transformer_decode"),
    "layer_index": lambda p: p.ModelSpec(backend="npu", layer_index=7),
    "npu_rows": lambda p: p.ModelSpec(npu_rows=8),
    "npu_grid": lambda p: p.ModelSpec(backend="npu", npu_cols=0),
    "geometry": lambda p: p.GeometrySpec(0),
    "ways": lambda p: p.GeometrySpec(8, ways=0),
    "dram": lambda p: p.DRAMSpec(banks=0),
    "row_bytes": lambda p: p.CampaignSpec(
        name="bad", geometries=(p.GeometrySpec(8, block=96),)),
    "empty": lambda p: p.CampaignSpec(name="bad", geometries=()),
    "version": lambda p: p.CampaignSpec.from_dict(
        {"spec_version": 2, "name": "x", "geometries": []}),
    "example_points": lambda p: p.example_spec(points=17),
    "mixed_even": lambda p: p.mixed_backend_spec(points=3),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validation_errors_match_reference(case):
    with pytest.raises(ValueError) as want:
        BAD_SPECS[case](J)
    with pytest.raises(ValueError) as got:
        BAD_SPECS[case](T)
    assert str(got.value) == str(want.value)


def test_backend_axis_preserves_pre_backend_hashes():
    d = T.ModelSpec(window_bursts=256).to_dict()
    assert d == {"name": "yolov3", "window_bursts": 256,
                 "chunk_bursts": 16, "layer_index": 40}
    ids = {t_spec.CampaignPoint(m, T.GeometrySpec(8, ways=2), T.MixSpec(),
                                T.DRAMSpec()).point_id
           for m in (T.ModelSpec(window_bursts=256),
                     T.ModelSpec(window_bursts=256, backend="npu",
                                 npu_rows=8, npu_cols=8),
                     T.ModelSpec(window_bursts=256, backend="npu"))}
    assert len(ids) == 3


# --------------------------------------------------------------------------
# clean runs: byte-identical to the reference's files
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["example", "mixed"])
def test_clean_run_files_byte_identical_to_reference(name, tmp_path):
    J.run_campaign(specs(J, name), str(tmp_path / "ref"))
    res = run(specs(T, name), tmp_path / "port")
    assert res.completed == len(specs(T, name).expand()) and not res.failed
    for f in ("journal.jsonl", "manifest.json"):
        assert read(tmp_path / "port", f) == read(tmp_path / "ref", f), f


def test_chip_smoke_campaign_anchors_are_the_references(tmp_path):
    """chip_smoke.py's acceptance spec is the benchmark's, and its (a),
    (b) and (c) anchors are the reference's (the simulated NPU times
    and the NPU oracle are pinned by the card run)."""
    from benchmarks.campaign_bench import _acceptance_spec
    from repro.core import npu as j_npu

    cs = chip_smoke()
    assert cs.acceptance_spec(64, 16384).to_dict() == \
        _acceptance_spec(64, 16384).to_dict()
    for spec, want, out in (
            (_acceptance_spec(64, 16384), cs.CAMPAIGN_ACCEPTANCE_SHA256, "a"),
            (J.mixed_backend_spec(16, window_bursts=16384),
             cs.CAMPAIGN_MIXED_SHA256, "b")):
        res = J.run_campaign(spec, str(tmp_path / out), batch_points=64)
        assert hashlib.sha256(read(tmp_path / out)).hexdigest() == want
        assert res.completed == len(spec.expand())
    for name, want in cs.NPU_MODEL_SECONDS.items():
        assert j_npu.npu_time_s(j_npu.workload(name))["seconds"] == want
    for name, (_, _, n_segs) in cs.NPU_SIM.items():
        assert sum(len(s) for s in j_npu.workload_op_segments(
            j_npu.workload(name))) == n_segs


# --------------------------------------------------------------------------
# resume and the journal
# --------------------------------------------------------------------------
def test_resume_is_noop_after_success(tmp_path):
    first = run(tiny(), tmp_path)
    second = run(tiny(), tmp_path, resume=True)
    assert second.executed == 0 and second.resumed == 4
    assert second.manifest == first.manifest


def test_existing_journal_requires_resume_or_overwrite(tmp_path):
    run(tiny(), tmp_path)
    with pytest.raises(T.JournalError, match="resume"):
        run(tiny(), tmp_path)
    assert run(tiny(), tmp_path, overwrite=True).executed == 4
    other = T.example_spec(points=2, window_bursts=128)
    with pytest.raises(T.JournalError, match="different campaign"):
        run(other, tmp_path, resume=True)


def test_torn_journal_tail_reruns_point(tmp_path):
    first = run(tiny(), tmp_path)
    journal = tmp_path / "journal.jsonl"
    lines = journal.read_text().splitlines(keepends=True)
    journal.write_text("".join(lines[:-2]) + lines[-2][:len(lines[-2]) // 2])
    res = run(tiny(), tmp_path, resume=True)
    assert res.dropped_records == 1
    assert res.executed == 1 and res.resumed == 3
    assert read(tmp_path) == json.dumps(
        first.manifest, indent=2, sort_keys=True).encode() + b"\n"


def test_journal_crc_rejects_bitflips(tmp_path):
    run(tiny(), tmp_path)
    journal = T.Journal(str(tmp_path / "journal.jsonl"))
    assert journal.replay()[1] == 0
    text = pathlib.Path(journal.path).read_text()
    bad = text.replace('"accesses":256', '"accesses":999', 1)
    assert bad != text
    pathlib.Path(journal.path).write_text(bad)
    assert journal.replay()[1] == 1
    res = run(tiny(), tmp_path, resume=True)
    assert res.executed == 1 and res.dropped_records == 1
    rec = {"kind": "done", "completed": 1, "failed": 0}
    assert record_crc({**rec, "crc": record_crc(rec)}) == record_crc(rec)
    with pytest.raises(ValueError, match="kind"):
        journal.append({"kind": "gremlin"})


def test_demoted_journal_record_is_rerun(tmp_path):
    """A record whose checksum holds but whose numbers break the
    closed-form identity is demoted to pending on resume."""
    from repro_torch.campaign.manifest import Journal

    run(tiny(), tmp_path)
    journal = Journal(str(tmp_path / "journal.jsonl"))
    records, _ = journal.replay()
    os.remove(journal.path)
    for rec in records:
        rec.pop("crc")
        if rec["kind"] == "point" and rec["point_id"] == \
                tiny().expand()[2].point_id:
            rec["result"] = {**rec["result"],
                             "total_cycles": rec["result"]["total_cycles"]
                             + 1}
        journal.append(rec)
    res = run(tiny(), tmp_path, resume=True)
    assert res.executed == 1 and res.dropped_records == 1


# --------------------------------------------------------------------------
# faults: retry, quarantine, equivalence
# --------------------------------------------------------------------------
def test_fault_equivalence_all_kinds(tmp_path):
    """A crash, a hang, a NaN, a consistent corruption and a torn write
    end on the clean run's bytes, which are the reference's."""
    spec = tiny()
    J.run_campaign(specs(J, "example"), str(tmp_path / "ref"))
    plan = T.plan_from_indices(spec, [
        {"point": 0, "kind": "nan"},
        {"point": 1, "kind": "crash"},
        {"point": 1, "kind": "corrupt"},
        {"point": 2, "kind": "hang", "hang_s": HANG_S},
        {"point": 3, "kind": "torn"},
    ])
    policy = T.RetryPolicy(max_retries=2, timeout_s=TIMEOUT_S,
                           backoff_s=0.01)
    notes: list = []
    res, runs = until_done(spec, tmp_path / "faulted", plan, policy,
                           progress=notes.append)
    assert runs == 3 and not res.failed
    assert read(tmp_path / "faulted") == read(tmp_path / "ref")
    for caught in ("finite", "monotone", "PointTimeout"):
        assert any(caught in n for n in notes), caught
    fired = read(tmp_path / "faulted", "faults_consumed.jsonl")
    assert len(fired.splitlines()) == 5


def test_nan_quarantine_and_retry_failed(tmp_path):
    spec = tiny()
    plan = T.plan_from_indices(spec, [{"point": 0, "kind": "nan"}])
    res = run(spec, tmp_path, policy=T.RetryPolicy(max_retries=0,
                                                   backoff_s=0),
              hooks=T.FaultInjector(plan, str(tmp_path)))
    assert res.manifest["counts"] == {"total": 4, "completed": 3,
                                      "failed": 1}
    (info,) = res.failed.values()
    assert "finite" in info["error"]
    keep = run(spec, tmp_path, resume=True,
               hooks=T.FaultInjector(plan, str(tmp_path)))
    assert keep.executed == 0 and keep.manifest["counts"]["failed"] == 1
    heal = run(spec, tmp_path, resume=True, retry_failed=True,
               hooks=T.FaultInjector(plan, str(tmp_path)))
    assert heal.completed == 4 and not heal.failed


def test_monotone_ways_guardrail_catches_consistent_corruption(tmp_path):
    # point 1 is the solo-mix ways=2 lane; deflating it keeps the
    # closed-form identity, so only LRU inclusion vs ways=1 trips
    spec = tiny()
    plan = T.plan_from_indices(spec, [{"point": 1, "kind": "corrupt"}])
    res = run(spec, tmp_path, policy=T.RetryPolicy(max_retries=0,
                                                   backoff_s=0),
              hooks=T.FaultInjector(plan, str(tmp_path)))
    (info,) = res.failed.values()
    assert "monotone" in info["error"]


def test_hang_times_out_and_recovers(tmp_path):
    spec = tiny()
    plan = T.plan_from_indices(spec, [{"point": 0, "kind": "hang",
                                       "hang_s": HANG_S}])
    res = run(spec, tmp_path,
              policy=T.RetryPolicy(max_retries=1, timeout_s=TIMEOUT_S,
                                   backoff_s=0.01),
              hooks=T.FaultInjector(plan, str(tmp_path)))
    assert res.completed == 4 and not res.failed
    assert res.manifest == run(spec, tmp_path / "clean").manifest


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="outside"):
        T.plan_from_indices(tiny(), [{"point": 99, "kind": "crash"}])
    with pytest.raises(ValueError, match="kind"):
        T.plan_from_indices(tiny(), [{"point": 0, "kind": "gremlin"}])


# --------------------------------------------------------------------------
# batched, mesh-sharded and mixed-backend execution
# --------------------------------------------------------------------------
def test_sequential_batched_and_mesh_manifests_identical(tmp_path):
    spec = specs(T, "example6")
    notes: list = []
    seq = run(spec, tmp_path / "seq", batch_points=1)
    bat = run(spec, tmp_path / "bat", progress=notes.append)
    msh = T.run_campaign(spec, str(tmp_path / "mesh"),
                         mesh=make_sweep_mesh([CPU] * 3),
                         progress=notes.append)
    assert seq.completed == bat.completed == msh.completed == 6
    assert read(tmp_path / "seq") == read(tmp_path / "bat") == \
        read(tmp_path / "mesh")
    assert not any("fell back" in n for n in notes)
    with pytest.raises(ValueError, match="not both"):
        T.run_campaign(spec, str(tmp_path / "both"), device=CPU,
                       mesh=make_sweep_mesh([CPU]))


def test_quarantine_mid_batch_stays_per_point(tmp_path):
    spec = specs(T, "example6")
    plan = T.plan_from_indices(spec, [{"point": 2, "kind": "nan"}])
    res = T.run_campaign(spec, str(tmp_path),
                         mesh=make_sweep_mesh([CPU] * 3),
                         policy=T.RetryPolicy(max_retries=0, backoff_s=0),
                         hooks=T.FaultInjector(plan, str(tmp_path)))
    assert res.manifest["counts"] == {"total": 6, "completed": 5,
                                      "failed": 1}


@pytest.mark.parametrize("kill_at,batch", [(0, 2), (1, 4), (3, 4), (2, 2)])
def test_crash_mid_batch_then_resume(kill_at, batch, tmp_path):
    spec = T.example_spec(points=4, window_bursts=128)
    clean = run(spec, tmp_path / "clean", batch_points=1)
    plan = T.plan_from_indices(spec, [{"point": kill_at, "kind": "crash"},
                                      {"point": 3 - kill_at, "kind": "torn"}])
    res, runs = until_done(spec, tmp_path / "f", plan,
                           T.RetryPolicy(max_retries=1, backoff_s=0),
                           batch_points=batch)
    assert runs == 3 and not res.failed
    assert read(tmp_path / "f") == read(tmp_path / "clean")
    assert clean.executed == 4


def test_mixed_backend_crash_resume_equals_reference(tmp_path):
    J.run_campaign(J.mixed_backend_spec(8, window_bursts=256),
                   str(tmp_path / "ref"))
    spec = T.mixed_backend_spec(8, window_bursts=256)
    backends = [p.model.backend for p in spec.expand()]
    plan = T.plan_from_indices(spec, [
        {"point": backends.index("nvdla"), "kind": "crash"},
        {"point": backends.index("npu") + 1, "kind": "crash"}])
    res, runs = until_done(spec, tmp_path / "f", plan,
                           T.RetryPolicy(max_retries=1, backoff_s=0))
    assert runs == 3 and not res.failed
    assert read(tmp_path / "f") == read(tmp_path / "ref")
    bat = run(spec, tmp_path / "bat", batch_points=8)
    assert read(tmp_path / "bat") == read(tmp_path / "ref")
    assert bat.executed == 8


def test_npu_points_replay_the_npu_window(tmp_path):
    from repro_torch.core import npu
    from repro_torch.core.cache import simulate_segments

    res = run(specs(T, "mixed"), tmp_path)
    npu_points = [p for p in res.manifest["points"]
                  if p["params"]["model"].get("backend") == "npu"]
    assert len(npu_points) == 2
    window = npu.npu_chunks(npu.workload("yolov3"),
                            npu.NPUConfig(rows=8, cols=8),
                            chunk_bursts=16, max_bursts=128)
    for p in npu_points:
        llc = T.GeometrySpec(**p["params"]["geometry"]).llc()
        ref = simulate_segments(window, llc, device=CPU)
        assert p["result"]["nvdla_accesses"] == ref.accesses
        assert p["result"]["nvdla_hits"] == ref.hits


# --------------------------------------------------------------------------
# the CLI and the device default
# --------------------------------------------------------------------------
def cli(argv, pkg_main=t_cli.main) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = pkg_main(argv)
    return rc, out.getvalue()


def test_cli_exit_codes_and_commands(tmp_path):
    from repro.campaign import cli as j_cli

    for argv in (["example", "--points", "4", "--window-bursts", "256"],
                 ["faults", "--crash", "1", "--nan", "0", "--torn", "2"]):
        assert cli(argv) == cli(argv, j_cli.main)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(cli(["example", "--points", "4",
                              "--window-bursts", "256"])[1])
    faults = tmp_path / "faults.json"
    faults.write_text(cli(["faults", "--crash", "1"])[1])
    base = ["run", str(spec_path), "--out", str(tmp_path / "c"),
            "--device", CPU, "--inject", str(faults)]
    assert cli(base)[0] == 42
    rc, out = cli(base + ["--resume"])
    assert rc == 0 and json.loads(out) == {"total": 4, "completed": 4,
                                           "failed": 0}
    rc, out = cli(["show", str(tmp_path / "c")])
    assert rc == 0 and "'completed': 4, 'failed': 0, 'total': 4" in out
    faults.write_text(cli(["faults", "--nan", "0"])[1])
    rc, _ = cli(["run", str(spec_path), "--out", str(tmp_path / "q"),
                 "--device", CPU, "--inject", str(faults), "--retries", "0",
                 "--batch-points", "1"])
    assert rc == 3
    rc, out = cli(["show", str(tmp_path / "nothing")])
    assert rc == 0 and "not written" in out
    J.run_campaign(specs(J, "example"), str(tmp_path / "ref"))
    assert read(tmp_path / "c") == read(tmp_path / "ref")


def test_entry_points_need_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.run_campaign(tiny(), str(tmp_path / "a"))
    spec_path = tmp_path / "spec.json"
    tiny().save(str(spec_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["run", str(spec_path), "--out", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cli.main(["run", str(spec_path), "--out", str(tmp_path / "c"),
                    "--mesh"])

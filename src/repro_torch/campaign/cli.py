"""Campaign CLI: ``python -m repro_torch.campaign <command>`` — the same
commands, flags and exit codes as the reference's ``python -m
repro.campaign``, plus ``--device``.

Commands:

* ``run SPEC --out DIR``  — run a campaign on ``--device`` (``cuda``
  unless asked otherwise) or over ``--mesh [N]`` (every visible CUDA
  device, or the first N); ``--resume`` continues a journaled one,
  ``--inject FAULTS.json`` wires up the deterministic fault harness (an
  injected crash exits with code ``42`` so scripts can distinguish a
  simulated death from a real error, then resume);
* ``example``             — print a tiny ready-to-run spec to stdout;
* ``faults``              — print a fault-plan JSON from point indices;
* ``show DIR``            — summarize a campaign directory's journal
  and manifest (completed/failed/pending counts).

Exit codes: 0 all points completed; 3 campaign finished but quarantined
points remain; 42 an injected fault simulated a process death (resume
with ``--resume``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.campaign.executor import RetryPolicy, run_campaign
from repro_torch.campaign.faults import (
    FaultInjector,
    InjectedCrash,
    plan_from_indices,
)
from repro_torch.campaign.manifest import JOURNAL_NAME, MANIFEST_NAME, Journal
from repro_torch.campaign.spec import CampaignSpec, example_spec
from repro_torch.launch.mesh import make_sweep_mesh
from repro_torch.utils.env import default_device

EXIT_FAILED_POINTS = 3
EXIT_INJECTED_CRASH = 42


def _cmd_run(args) -> int:
    spec = CampaignSpec.load(args.spec)
    hooks = None
    if args.inject:
        with open(args.inject) as f:
            plan = plan_from_indices(spec, json.load(f))
        hooks = FaultInjector(plan, args.out)
    policy = RetryPolicy(max_retries=args.retries,
                         timeout_s=args.timeout,
                         backoff_s=args.backoff)
    mesh, device = None, default_device(args.device)
    if args.mesh is not None:
        if device.type != "cuda":
            raise SystemExit("--mesh shards over CUDA devices; drop "
                             "--device or pass --device cuda")
        mesh = make_sweep_mesh()
        if args.mesh >= 0:
            mesh = make_sweep_mesh(mesh.devices[:args.mesh])
        device = None
        print(f"sweep mesh: {len(mesh.devices)} device(s)",
              file=sys.stderr)
    try:
        res = run_campaign(spec, args.out, resume=args.resume,
                           overwrite=args.overwrite, policy=policy,
                           hooks=hooks, retry_failed=args.retry_failed,
                           progress=lambda m: print(m, file=sys.stderr),
                           mesh=mesh, batch_points=args.batch_points,
                           device=device)
    except InjectedCrash as e:
        print(f"simulated process death: {e}", file=sys.stderr)
        return EXIT_INJECTED_CRASH
    print(json.dumps(res.manifest["counts"]))
    return EXIT_FAILED_POINTS if res.failed else 0


def _cmd_example(args) -> int:
    spec = example_spec(points=args.points,
                        window_bursts=args.window_bursts)
    json.dump(spec.to_dict(), sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


def _cmd_faults(args) -> int:
    entries = []
    for kind in ("crash", "hang", "nan", "corrupt", "torn"):
        for idx in getattr(args, kind) or ():
            entries.append({"point": idx, "kind": kind})
    json.dump(entries, sys.stdout, indent=2)
    print()
    return 0


def _cmd_show(args) -> int:
    journal = Journal(os.path.join(args.dir, JOURNAL_NAME))
    records, dropped = journal.replay()
    kinds = {}
    for rec in records:
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
    print(f"journal: {len(records)} records {dict(sorted(kinds.items()))}"
          f", {dropped} corrupt/torn lines")
    manifest_path = os.path.join(args.dir, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            m = json.load(f)
        print(f"manifest: campaign {m['campaign']!r} "
              f"spec {m['spec_hash']} counts {m['counts']}")
        for fp in m["failed_points"]:
            print(f"  failed {fp['point_id']}: {fp.get('error', '')}")
    else:
        print("manifest: not written (campaign incomplete — resume it)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.campaign",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run or resume a campaign")
    run_p.add_argument("spec", help="campaign spec JSON file")
    run_p.add_argument("--out", required=True, help="campaign directory")
    run_p.add_argument("--resume", action="store_true",
                       help="replay the journal and run only missing points")
    run_p.add_argument("--overwrite", action="store_true",
                       help="discard an existing journal and start over")
    run_p.add_argument("--retry-failed", action="store_true",
                       help="with --resume, also re-run quarantined points")
    run_p.add_argument("--retries", type=int, default=2,
                       help="max retries per point (default 2)")
    run_p.add_argument("--timeout", type=float, default=None,
                       help="per-point wall-clock timeout in seconds")
    run_p.add_argument("--backoff", type=float, default=0.05,
                       help="base retry backoff in seconds")
    run_p.add_argument("--inject", default=None,
                       help="fault-plan JSON (see the 'faults' command)")
    run_p.add_argument("--mesh", nargs="?", const=-1, default=None,
                       type=int, metavar="N",
                       help="shard point batches over a mesh of the "
                            "visible CUDA devices (all of them, or the "
                            "first N)")
    run_p.add_argument("--batch-points", type=int, default=32,
                       help="max points per batched lane program "
                            "(1 = strictly sequential; default 32)")
    run_p.add_argument("--device", default=None,
                       help="torch device of the lanes (default cuda; "
                            "'cpu' runs them on the CPU)")
    run_p.set_defaults(func=_cmd_run)

    ex_p = sub.add_parser("example", help="print a tiny example spec")
    ex_p.add_argument("--points", type=int, default=8)
    ex_p.add_argument("--window-bursts", type=int, default=512)
    ex_p.set_defaults(func=_cmd_example)

    f_p = sub.add_parser("faults", help="print a fault plan JSON")
    for kind in ("crash", "hang", "nan", "corrupt", "torn"):
        f_p.add_argument(f"--{kind}", type=int, action="append",
                         metavar="POINT_INDEX",
                         help=f"inject a {kind} fault at this spec-order "
                              "point index (repeatable)")
    f_p.set_defaults(func=_cmd_faults)

    show_p = sub.add_parser("show", help="summarize a campaign directory")
    show_p.add_argument("dir")
    show_p.set_defaults(func=_cmd_show)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""The serial kernels' step loops in the compiled SASS: the dependency floor.

    python scripts/llc_sass.py [--ways 8] [--clock-mhz F]

Builds ``csrc/llc.cu`` and ``csrc/noc.cu`` (as the port does),
disassembles the libraries with ``cuobjdump -sass`` and, for
``llc_set_walk_kernel<W>``, ``llc_lane_scan_kernel<W>``,
``noc_switch_kernel`` and the wide routes (``llc_set_walk_warp_kernel``,
``llc_set_walk_mem_kernel``, ``llc_lane_scan_wide_kernel``,
``noc_switch_wide_kernel``), finds every loop (a backward branch) and
reports its instruction count and the longest chain of dependent
instructions in one pass through its body (register and predicate
def-use, in address order; a predicated write also reads the old
value).  The step loop of each kernel is the one that holds its step's
marker: the set walk's loop stores a hit bit to shared memory
(``STS.U8``) once a step, the lane scan's round loop does a 32 x 32
multiply-high (``IMAD.HI.U32``) for j_hi and j_lo twice a round, the
switch's cycle loop groups the heads by ``MATCH`` once a target cycle;
the warp routes reduce over the lanes (``REDUX``) twice a step or
round, the block route meets at ``BAR.SYNC`` at least twice a cycle.
Loops inside a step loop (the warp routes' walks over a lane's ways,
the block route's over a thread's ports) count their chain once a trip:
the chain a step is the step loop's own chain plus each inner loop's
chain times its trips (``floor_ns_a_step``).  The dependency floor of a
walk is its longest chain of steps times the chain a step, at one cycle
a dependent instruction and the SM clock given (no dependent
instruction completes in under a cycle; Hopper's integer pipes take
about four).  Writes the SASS and a JSON summary to
``chiprun_out/llc_sass/``.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``); no card.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                  r"([A-Z0-9_.]+)\s*([^;]*);")
REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "EXIT", "BAR", "BSYNC",
           "BSSY", "WARPSYNC", "NOP", "CALL", "RET", "SYNCS", "LDGSTS",
           "DEPBAR", "MEMBAR", "ERRBAR", "CCTL", "YIELD", "JMP", "BPT")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def functions(sass: str) -> dict[str, list]:
    """Each function's instructions: (address, guard, opcode, operands)."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16),
                                  (m.group(2) or "").strip(), m.group(3),
                                  m.group(4)))
    return out


def loops(insns: list) -> list[tuple[int, int]]:
    """(first, last) instruction index of every backward branch's loop."""
    at = {a: i for i, (a, *_) in enumerate(insns)}
    found = []
    for i, (_, _, op, args) in enumerate(insns):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            target = at.get(int(m.group(1), 16)) if m else None
            if target is not None and target <= i:
                found.append((target, i))
    return found


def chain(body: list) -> int:
    """The longest def-use chain (instructions) through ``body`` in
    address order."""
    depth: dict[str, int] = {}
    longest = 0
    for _, guard, op, args in body:
        regs = REG.findall(args)
        base = op.split(".")[0]
        dests = [] if base in NO_DEST or not regs else [regs[0]]
        if base in ("ISETP", "FSETP", "PLOP3", "LOP3") and op.startswith(
                ("ISETP", "FSETP", "PLOP3")) and len(regs) > 1 \
                and regs[1].startswith("P"):
            dests = regs[:2]
        if base == "IMAD" and ".WIDE" in op and regs:
            n = int(re.sub(r"\D", "", regs[0]))
            dests = [regs[0], f"R{n + 1}"]
        srcs = regs[len(dests):] + REG.findall(guard)
        if guard:
            srcs += dests
        d = 1 + max((depth.get(r, 0) for r in srcs if r not in ("PT", "RZ")),
                    default=0)
        for r in dests:
            depth[r] = d
        longest = max(longest, d)
    return longest


def summarize(insns: list, marker: str, per_step: int) -> dict:
    """The loops of one function and the step loop: the innermost loop
    that holds ``marker`` (``per_step`` of them a step).  Loops inside
    the step loop, outermost ones only, are its ``inner`` loops: the
    step loop's own ``outer_chain`` leaves their instructions out."""
    rows, spans = [], loops(insns)
    for lo, hi in spans:
        body = insns[lo:hi + 1]
        marks = sum(op.startswith(marker) for _, _, op, _ in body)
        rows.append({"first": hex(insns[lo][0]), "last": hex(insns[hi][0]),
                     "instructions": len(body), "chain": chain(body),
                     "markers": marks, "span": (lo, hi)})
    steps = [r for r in rows if r["markers"] >= per_step]
    step = min(steps, key=lambda r: r["instructions"]) if steps else None
    if step is not None:
        lo, hi = step["span"]
        inside = [(a, b) for a, b in spans if lo <= a and b <= hi
                  and (a, b) != (lo, hi)]
        inner = [(a, b) for a, b in inside
                 if not any(c <= a and b <= d and (c, d) != (a, b)
                            for c, d in inside)]
        own = [x for i, x in enumerate(insns[lo:hi + 1], lo)
               if not any(a <= i <= b for a, b in inner)]
        unroll = max(1, step["markers"] // per_step)
        step = dict(step, steps_a_pass=unroll,
                    instructions_a_step=step["instructions"] / unroll,
                    chain_a_step=step["chain"] / unroll,
                    outer_chain=chain(own),
                    inner=[{"instructions": b - a + 1,
                            "chain": chain(insns[a:b + 1])}
                           for a, b in inner])
    for r in rows:
        r.pop("span")
    if step is not None:
        step.pop("span")
    return {"loops": rows, "step_loop": step}


# the wide routes' step loops: (source, mangled name, marker, markers a
# step)
WIDE = {"llc_set_walk registers": ("llc", "llc_set_walk_warp_kernelILi8E",
                                   "REDUX", 2),
        "llc_set_walk shared": ("llc", "llc_set_walk_mem_kernelILb1E",
                                "REDUX", 2),
        "llc_set_walk global": ("llc", "llc_set_walk_mem_kernelILb0E",
                                "REDUX", 2),
        "llc_lane_scan warp shared": ("llc",
                                      "llc_lane_scan_wide_kernelILb1E",
                                      "REDUX", 2),
        "llc_lane_scan warp global": ("llc",
                                      "llc_lane_scan_wide_kernelILb0E",
                                      "REDUX", 2),
        "noc_switch block": ("noc", "noc_switch_wide_kernel", "BAR.SYNC",
                             2)}


_SASS: dict[str, dict] = {}   # each library's functions, disassembled once


def wide_floor_ns(name: str, trips: int, clock_mhz: float) -> dict:
    """The dependency floor a step of a wide route (``WIDE``), in ns at
    ``clock_mhz``: the step loop's own chain plus each inner loop's
    chain times ``trips`` (a lane's ways, ceil(ways / 32), or a thread's
    ports), one cycle a dependent instruction.  Builds and disassembles
    the library (``cuobjdump``)."""
    from repro_torch.kernels import _build

    source, mangled, marker, per_step = WIDE[name]
    if source not in _SASS:
        _build.library(source)
        lib = _build._target(_build.CSRC / f"{source}.cu")
        _SASS[source] = functions(subprocess.run(
            [_cuobjdump(), "-sass", str(lib)], check=True,
            capture_output=True, text=True).stdout)
    funcs = _SASS[source]
    hits = [f for f in funcs if mangled in f]
    if not hits:
        raise SystemExit(f"{mangled} not in the SASS of {source}.cu")
    step = summarize(funcs[hits[0]], marker, per_step)["step_loop"]
    if step is None:
        raise SystemExit(f"{name}: no loop holds {per_step} {marker}")
    chain_a_step = step["outer_chain"] + trips * sum(
        i["chain"] for i in step["inner"])
    return {"chain_a_step": chain_a_step, "trips": trips,
            "floor_ns_a_step": chain_a_step * 1e3 / clock_mhz,
            "outer_chain": step["outer_chain"],
            "inner_chains": [i["chain"] for i in step["inner"]]}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ways", type=int, default=8)
    ap.add_argument("--clock-mhz", type=float, default=None)
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build

    _build.build()
    out_dir = ROOT / "chiprun_out" / "llc_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    funcs, libs = {}, {}
    for source in ("llc", "noc"):
        lib = _build._target(_build.CSRC / f"{source}.cu")
        sass = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        (out_dir / f"{source}.sass").write_text(sass)
        funcs.update(functions(sass))
        libs[source] = lib.name
    # the set walk's instance for exactly `ways` ways (kExact), as
    # launched; the switch's cycle loop matches the heads once a cycle
    want = {"llc_set_walk": (f"llc_set_walk_kernelILi{args.ways}ELb1E",
                             "STS.U8", 1),
            "llc_lane_scan": (f"llc_lane_scan_kernelILi{args.ways}E",
                              "IMAD.HI.U32", 2),
            "noc_switch": ("noc_switch_kernel", "MATCH", 1),
            **{name: w[1:] for name, w in WIDE.items()}}
    report = {"libraries": libs, "ways": args.ways,
              "clock_mhz": args.clock_mhz}
    for name, (mangled, marker, per_step) in want.items():
        hits = [f for f in funcs if mangled in f]
        if not hits:
            raise SystemExit(f"{mangled} not in the SASS of {libs}")
        res = summarize(funcs[hits[0]], marker, per_step)
        res["function"] = hits[0]
        step = res["step_loop"]
        if step is not None and args.clock_mhz:
            res["floor_ns_a_step"] = (step["chain_a_step"] * 1e3
                                      / args.clock_mhz)
        report[name] = res
        print(f"{name} ({hits[0]}): {len(funcs[hits[0]])} instructions, "
              f"{len(res['loops'])} loops")
        for r in res["loops"]:
            print(f"  loop {r['first']}..{r['last']}: {r['instructions']} "
                  f"instructions, chain {r['chain']}, {marker} "
                  f"x{r['markers']}")
        print(f"  step loop: {json.dumps(step)}")
    (out_dir / "summary.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

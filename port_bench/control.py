"""The readings a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs never run this).

    python3 port_bench/control.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] \\
        [--faults unchanged_state,...] [--out FILE]

For each seed, the plain reference's step in float32 over check 0
(``harness.reference``), then, where the seed is listed:

* ``--seeds``: the program's check 0 (set-up and the window's own call,
  no window), held against it: the sound runs, whose largest number is
  a limit's lower reading;
* ``--control-seeds``: the control, the same reference computed with
  float8 e4m3 products (``common.FP8``) in the program's place;
* ``--fault-seeds``: the program's check 0 under each fault of
  ``faults.py``.

Every number of every run goes to ``--out`` (JSON) and one line a run to
standard output; the last lines give each number's lower reading (the
largest over the sound runs) and upper reading (the smallest over the
control and the faults).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder first on the path would shadow the standard library
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    del sys.path[0]


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # a check allocates the same large blocks every time: kept whole, they
    # serve every check, where expandable segments took the allocator's
    # retry path (free every cached block) once a check
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "max_split_size_mb:256"
    from port_bench import faults, harness, judge
    from port_bench.reference import common

    cell = harness.load_cell(args.workload, args.root)
    dev = harness.device_of(args.device)
    common.no_tf32()
    card = harness._Card(dev)
    names = [f for f in args.faults.split(",") if f] or list(faults.FAULTS)
    runs = []

    def program(seed, fault=None):
        prog = harness.Program(cell, seed, dev)
        if fault is None:
            res = prog.check(0)
        else:
            with faults.FAULTS[fault]():
                res = prog.check(0)
        readings = prog.readings(res)
        del res
        prog.close()
        card.free()
        return readings

    def record(kind, seed, readings, ref, t0):
        where = {}
        nums = judge.numbers(readings, ref, where=where)
        runs.append({"kind": kind, "seed": seed, "numbers": nums,
                     "worst_leaf": {k: v[1] for k, v in where.items()},
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(runs[-1]), flush=True)

    for seed in dict.fromkeys(args.seeds + args.control_seeds
                              + args.fault_seeds):
        t0 = time.perf_counter()
        ref = harness.reference(cell, seed, dev)
        card.free()
        print(f"reference seed {seed}: {time.perf_counter() - t0:.3f} s",
              flush=True)
        if seed in args.seeds:
            t0 = time.perf_counter()
            record("program", seed, program(seed), ref, t0)
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            ctrl = harness.reference(cell, seed, dev, common.FP8)
            card.free()
            record("control", seed, judge.reference_readings(ctrl), ref, t0)
        if seed in args.fault_seeds:
            for fault in names:
                t0 = time.perf_counter()
                record(fault, seed, program(seed, fault), ref, t0)
    summary = {}
    for name in sorted({k for r in runs for k in r["numbers"]}):
        sound = [r["numbers"][name] for r in runs if r["kind"] == "program"
                 and name in r["numbers"]]
        other = {r["kind"]: min(x["numbers"][name] for x in runs
                                if x["kind"] == r["kind"])
                 for r in runs if r["kind"] != "program"
                 and name in r["numbers"]}
        summary[name] = {"lower": max(sound) if sound else None,
                         "upper_by": other}
        print(f"{name}: lower {summary[name]['lower']!r}, upper {other}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "device": card.describe(),
             "runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

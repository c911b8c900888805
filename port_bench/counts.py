"""The program's counters over the checks of a cell's window, on the card
(the benchmark's runs never run this: their record keeps each check's
``seconds``, not its ``counts``).

    python3 port_bench/counts.py --workload <cell> --seeds 11,12,... \\
        --checks N [--prefix moe.] [--out FILE]

For each seed, the program is set up as a run of the cell sets it up,
and checks 0 to N run on the batches a run of that seed draws (check 0
the warm-up, 1 to N the window's).  One line a check gives its
``TTraceResult.counts`` whose key holds ``--prefix`` after its step
(``estimate.moe.dropped``, ``candidate.moe.rows_held``, ...); the last
line gives each such key's largest value over every check of every seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the script's own folder first on the path would shadow the standard library
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    del sys.path[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--checks", type=int, required=True)
    ap.add_argument("--prefix", default="moe.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "max_split_size_mb:256"
    from port_bench import harness
    from port_bench.reference import common

    cell = harness.load_cell(args.workload, args.root)
    dev = harness.device_of(args.device)
    common.no_tf32()
    card = harness._Card(dev)
    rows, most = [], {}
    for seed in (int(s) for s in args.seeds.split(",") if s):
        prog = harness.Program(cell, seed, dev)
        for i in range(args.checks + 1):
            res = prog.check(i)
            got = {k: v for k, v in res.counts.items()
                   if k.split(".", 1)[-1].startswith(args.prefix)}
            del res
            rows.append({"seed": seed, "check": i, "counts": got})
            print(json.dumps(rows[-1]), flush=True)
            for k, v in got.items():
                most[k] = max(most.get(k, v), v)
        prog.close()
        card.free()
    print(json.dumps({"largest": most}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "device": card.describe(),
             "checks": rows, "largest": most}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

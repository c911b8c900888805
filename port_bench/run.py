"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout (``BENCHMARK.json`` beside ``port_bench/``
and the program under ``src/``).  The run needs the cell's cards and has
no CPU fallback.  Its last line on standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` the per-layer metrics and ``breakdown``, and last
``compared``: each number compared beside its limit, which the last lines
on standard error repeat).  Kernels build into ``build/`` of the
checkout (``repro_torch.kernels.build``), at the first run there.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# host threads of torch, OpenMP and BLAS: the check's host work is one
# Python thread and numpy's generator, and 1, 2 or 8 threads check alike,
# so the run keeps its load on the shared host small and the same
THREADS = 2
# the script's own folder first on the path would shadow the standard library
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    del sys.path[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # a check allocates the same large blocks every time: kept whole, they
    # serve every check, where expandable segments took the allocator's
    # retry path (free every cached block) once a check
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "max_split_size_mb:256"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch
    torch.set_num_threads(THREADS)
    from port_bench import harness
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), root=ROOT,
                                     t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

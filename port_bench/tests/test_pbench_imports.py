"""What a run may load: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; compared whole, so
``repro_torch`` passes), and a reference free of the program; and the
entry refuses to run without a card."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from port_bench.tests import tiny

ENV = {**os.environ, "PYTHONPATH": f"{tiny.REPO / 'src'}:{tiny.REPO}"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, env=ENV, cwd=tiny.REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.write_root(tmp_path)
    tops = _loaded(
        "from port_bench import harness\n"
        f"harness.run_cell('q', 5, 0.0, False, device='cpu', root={str(root)!r},"
        " log=lambda _: None)\n"
        "assert not harness.forbidden_modules()")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    tops = _loaded("import port_bench.reference.qwen, "
                   "port_bench.reference.mixtral, port_bench.judge, "
                   "port_bench.arith, port_bench.weights")
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_entry_refuses_without_a_card():
    env = {**ENV, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "check.codeqwen1.5-7b.tp2sp.1x4096", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tiny.REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

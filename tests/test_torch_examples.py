"""The port's example scripts run end to end on the CPU."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_find_injected_bug_flags_paper_bug_6():
    """``moe_router_not_synced`` needs an MoE arch: the example builds
    reduced ``mixtral-8x7b`` for it and localizes the bug to an MLP."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_find_injected_bug.py"),
         "moe_router_not_synced", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "expected module: layers.*.mlp" in lines
    loc = [ln for ln in lines if ln.startswith("TTrace localized:")]
    assert loc, out.stdout[-3000:]
    module = loc[-1].split(":", 1)[1].strip()
    assert module.startswith("layers.") and module.endswith(".mlp"), module
    assert "FAIL" in out.stdout

"""The port's example scripts run end to end on the CPU, with the
reference scripts' verdicts."""
import math
import os
import subprocess
import sys
import tempfile

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


def _run(script, *args, timeout=600):
    """Run an example; the supervisor's work directory, which a script
    without ``work_dir`` leaves behind in ``TMPDIR``, goes with the run."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1", TMPDIR=tmp)
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "examples", script), *args,
             "--device", "cpu"],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=ROOT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout.splitlines()


def test_quickstart_trains_and_passes():
    """75 tensors, as the reference's quickstart compares: 12 taps twice
    and 17 parameters three times (reduced tinyllama, 2 layers, untied)."""
    lines = _run("torch_quickstart.py")
    assert "TTrace check (candidate == reference): PASS" in lines
    assert "  75 tensors compared, 0 flagged" in lines
    losses = [float(ln.split()[-1]) for ln in lines
              if ln.startswith("  step ")]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)


def test_threshold_estimation_prints_one_row_per_tap():
    """Reduced gpt-paper at 8 layers: 5 taps a layer plus the embedding
    output and the final norm, in ``fwd_order``."""
    lines = _run("torch_threshold_estimation.py")
    head = lines.index(f"{'tensor':48s} {'act':>8s} {'act_grad':>9s}")
    rows = [ln.split() for ln in lines[head + 1:] if ln.strip()][:-1]
    names = [r[0] for r in rows]
    assert len(names) == 5 * 8 + 2 == len(set(names))
    assert names[0] == "embedding/output" and names[-1] == "final_norm_out"
    assert all(float(r[1]) > 0 and float(r[2]) > 0 for r in rows)


def test_loss_curve_blindness_detects_the_bug():
    lines = _run("torch_loss_curve_blindness.py", "4")
    text = "\n".join(lines)
    assert "would NOT trip a 3% alarm" in text
    assert "-> detected the bug" in text
    sup = [ln for ln in lines if ln.startswith("supervisor:")]
    assert sup and "first flagged step 0," in sup[0], text[-2000:]


def _reference_combos(max_devices):
    """The reference sweep's combination list: its own loop, run over the
    JAX ``ParallelConfig`` (the script runs it at import)."""
    import ast
    import itertools
    import types
    from repro.parallel.api import ParallelConfig
    path = os.path.join(ROOT, "examples", "parallelism_sweep.py")
    tree = ast.parse(open(path).read(), path)
    body = tree.body
    i = next(k for k, node in enumerate(body)
             if isinstance(node, ast.Assign)
             and getattr(node.targets[0], "id", None) == "combos")
    assert isinstance(body[i + 1], ast.For)
    code = compile(ast.Module(body=body[i:i + 2], type_ignores=[]), path,
                   "exec")
    ns = {"itertools": itertools, "ParallelConfig": ParallelConfig,
          "bugs": frozenset(),
          "args": types.SimpleNamespace(max_devices=max_devices)}
    exec(code, ns)
    return ns["combos"]


@pytest.mark.parametrize("max_devices", [2, 4, 8])
def test_sweep_combinations_are_the_references(max_devices):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_parallelism_sweep",
        os.path.join(ROOT, "examples", "torch_parallelism_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def key(pc):
        return (pc.dp, pc.cp, pc.tp, pc.sp, pc.zero1, pc.n_devices)

    got = [key(pc) for pc in mod.sweep_combos(max_devices)]
    assert got == [key(pc) for pc in _reference_combos(max_devices)]
    assert len(got) == {2: 8, 4: 18, 8: 22}[max_devices]


def test_sweep_flags_the_tp_bug_where_tp_runs():
    lines = _run("torch_parallelism_sweep.py", "--max-devices", "2",
                 "--bug", "tp_wrong_embedding_mask")
    rows = [ln.split() for ln in lines
            if ln.split()[:1] in (["1"], ["2"]) and len(ln.split()) >= 6]
    assert len(rows) == 8
    for dp, cp, tp, sp, z1, verdict, *_ in rows:
        assert verdict == ("FAIL" if tp == "2" else "PASS"), rows
    assert "4/8 combinations equivalent to the reference" in "\n".join(lines)

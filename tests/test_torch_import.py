"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax``, nor anything of ``repro``, nor ``ml_dtypes`` (which the
card's machine does not have), and no source of the port, of
``chip_smoke.py`` or of an ``examples/torch_*.py`` imports them."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _examples():
    ex = os.path.join(ROOT, "examples")
    return sorted(os.path.join(ex, f) for f in os.listdir(ex)
                  if f.startswith("torch_") and f.endswith(".py"))


def _modules():
    mods = []
    for path in _sources()[1:]:
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


REFUSED = ("jax", "jaxlib", "repro", "ml_dtypes")


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.core.harness" in mods and len(mods) >= 74
    assert {"repro_torch.precision.fp8", "repro_torch.kernels.fp8_matmul",
            "repro_torch.bugs.registry", "repro_torch.models.ssm",
            "repro_torch.kernels.ssm_scan",
            "repro_torch.configs.rwkv6_7b", "repro_torch.configs.zamba2_7b",
            "repro_torch.configs.qwen3_32b",
            "repro_torch.configs.codeqwen15_7b",
            "repro_torch.configs.qwen15_110b",
            "repro_torch.configs.llava_next_34b",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.checkpoint.store",
            "repro_torch.supervise", "repro_torch.supervise.runner",
            "repro_torch.supervise.pipeline", "repro_torch.supervise.store",
            "repro_torch.supervise.bisect", "repro_torch.supervise.journal",
            "repro_torch.supervise.watchdog", "repro_torch.supervise.faults",
            "repro_torch.launch.supervise", "repro_torch.parallel.pp",
            "repro_torch.parallel.pp1f1b", "repro_torch.core.merger",
            "repro_torch.core.canonical",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo", "repro_torch.launch.mesh",
            "repro_torch.sharding.rules"} <= set(mods)
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{REFUSED!r})\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


def test_every_port_example_is_scanned():
    names = {os.path.basename(p) for p in _examples()}
    assert {"torch_find_injected_bug.py", "torch_supervised_run.py",
            "torch_quickstart.py", "torch_threshold_estimation.py",
            "torch_loss_curve_blindness.py",
            "torch_parallelism_sweep.py"} <= names


@pytest.mark.parametrize("path", _sources() + _examples(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in REFUSED, (path, n)

"""Shared test infrastructure.

The multi-device tests (the real 1F1B pipeline engine, in-process shard_map
candidates) need a multi-device platform INSIDE the main pytest process, and
XLA only honors ``--xla_force_host_platform_device_count`` if it is set
before jax initializes its backends.  conftest is imported before any test
module, so exporting here is early enough for a normal ``pytest`` run; when
the env arrives too late anyway (jax already initialized by an earlier
plugin/session), ``forced_devices`` falls back to spawning a worker process
with the env set — tests that need in-process devices skip with a pointer,
tests that can run code in a worker use ``run_in_worker``.
"""
import os

if "XLA_FLAGS" not in os.environ:                       # noqa: E402
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess integration tests")
    config.addinivalue_line(
        "markers", "multidevice: needs >= 4 in-process devices (deselect "
        "with -m 'not multidevice' for a fast tier-1 lane)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (PyTorch port kernels); skips "
        "on a machine without one")


def run_in_worker(code: str, devices: int = 8, timeout: int = 2400) -> str:
    """Run ``code`` in a fresh interpreter with ``devices`` forced host
    devices — the spawned-worker fallback for environments where this
    process's jax initialized before the XLA_FLAGS export."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    return out.stdout


@pytest.fixture(scope="session")
def forced_devices():
    """Session guarantee of a multi-device in-process platform.

    Returns the live device count; skips (pointing at ``run_in_worker``)
    when jax initialized before the forced-count export could take effect."""
    import jax
    n = len(jax.devices())
    if n < 4:
        pytest.skip(f"only {n} in-process device(s): jax initialized before "
                    f"XLA_FLAGS could force 8 — use conftest.run_in_worker "
                    f"for this test")
    return n


@pytest.fixture(scope="session")
def worker_run():
    """The spawned-worker runner as a fixture (multi-device e2e CLI tests)."""
    return run_in_worker

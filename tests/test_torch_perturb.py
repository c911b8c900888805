"""The threshold estimate's embedding perturbation, drawn ahead on a host
worker and finished on the tap's device (``core/thresholds``,
``core/generator``).

* ``perturb_direction`` and ``perturb_scale`` composed are the reference's
  ``perturb`` bit for bit, over more than one chunk of the draw, on
  random, all-zero and bf16-rounded inputs.
* The rewrite is ``perturb(to_numpy(tap))`` bit for bit on every tap dtype,
  for a zero tap, and under a float64 eps.
* Drawn ahead in several threads at once, each rewrite is its own
  seed's perturbation.

``estimate_thresholds`` with and without the tap's shape, and the card's
half, are in ``test_torch_spans.py`` (a file that imports no JAX).
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import generator as JG  # noqa: E402
from repro_torch.core import generator as G  # noqa: E402
from repro_torch.core import thresholds as T  # noqa: E402
from repro_torch.core.collector import Trace, to_numpy  # noqa: E402

EMB = "embedding/output"
EPS = T.MACHINE_EPS["bfloat16"]


def setup_module():
    torch.set_num_threads(1)     # the suite runs under several workers


def _x(kind, shape):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "bf16":
        return torch.from_numpy(x).bfloat16().float().numpy()
    return x


@pytest.mark.parametrize("kind", ["random", "zeros", "bf16"])
def test_halves_compose_to_the_reference_perturb(kind):
    shape = (3, G._CHUNK // 2 + 7)          # the draw takes two chunks
    x = _x(kind, shape)
    want = JG.perturb(x, EPS, seed=11)
    out = np.full(shape, np.nan, np.float32)
    d, nd = G.perturb_direction(shape, 11, out=out)
    assert d is out
    s = G.perturb_scale(np.linalg.norm(x), nd, EPS)
    got = x if s is None else x + d * s
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(G.perturb(x, EPS, seed=11), want)
    assert (s is None) == (kind == "zeros")


def _trace(tap):
    tr = Trace()
    tr.activations[EMB] = tap
    return tr


def _ahead(tap, seed):
    """The direction drawn ahead for ``tap``'s shape, as the estimate
    starts it before the base run of a runner that gives the shape."""
    def runner(batch, rewrites=None):
        return None

    runner.tap_shape = lambda batch: tuple(tap.shape)
    pre = T._prefetch(runner, {"tokens": np.zeros(tap.shape[:2], np.int64)}, seed)
    assert pre is not None
    return pre


@pytest.mark.parametrize("dtype,eps,zero", [
    (torch.bfloat16, EPS, False), (torch.float32, EPS, False),
    (torch.float16, EPS, False), (torch.float64, EPS, False),
    (torch.float32, EPS, True), (torch.float32, np.float64(EPS), False)])
def test_rewrite_is_the_perturbation_of_the_tap(dtype, eps, zero):
    tap = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(1))
    tap = (tap * 0 if zero else tap).to(dtype)
    want = G.perturb(to_numpy(tap), eps, seed=3)
    for pre in (None, _ahead(tap, 3)):
        rew = T._tap_rewrites(_trace(tap), eps, 3, pre)[EMB]
        assert rew.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(rew.numpy(), want)


def test_threads_each_get_their_own_seeds_perturbation():
    tap = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(2))
    wrong = []

    def estimate(seed):
        for _ in range(4):
            rew = T._tap_rewrites(_trace(tap), EPS, seed,
                                  _ahead(tap, seed))[EMB]
            if not np.array_equal(rew.numpy(),
                                  G.perturb(tap.numpy(), EPS, seed)):
                wrong.append(seed)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=estimate, args=(seed,))
                   for seed in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []

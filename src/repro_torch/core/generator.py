"""Consistent tensor generator (paper §4.2); copy of ``repro/core/generator.py``.

The canonical identifier of a tensor is hashed into a seed for numpy's
Philox generator, so the generated values are independent of device,
framework and backend: the port's rewrites and perturbations are the
reference's bit for bit.  Sharded generation arrives with the distributed
candidates.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.canonical import CanonicalId


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(seed))


def generate(cid, shape, dtype="float32", dist: str = "normal",
             scale: float = 1.0) -> np.ndarray:
    """Generate the logical full tensor for ``cid`` (CanonicalId or str)."""
    seed = cid.seed() if isinstance(cid, CanonicalId) else \
        CanonicalId(0, 0, "gen", str(cid), "value").seed()
    rng = _rng(seed)
    if dist == "normal":
        x = rng.standard_normal(shape, dtype=np.float32) * scale
    elif dist == "uniform":
        x = (rng.random(shape, dtype=np.float32) * 2 - 1) * scale
    else:
        raise ValueError(dist)
    return x.astype(dtype)


def perturb(x: np.ndarray, rel_eps: float, seed: int = 0) -> np.ndarray:
    """x + dX with ||dX|| = rel_eps * ||x|| (threshold estimation, §5.2)."""
    rng = _rng(seed ^ 0x9E3779B97F4A7C15)
    d = rng.standard_normal(x.shape).astype(np.float32)
    nx = np.linalg.norm(x.astype(np.float32))
    nd = np.linalg.norm(d)
    if nd == 0 or nx == 0:
        return x
    return (x.astype(np.float32) + d * (rel_eps * nx / nd)).astype(x.dtype)

"""Consistent tensor generator (paper §4.2); copy of ``repro/core/generator.py``.

The canonical identifier of a tensor is hashed into a seed for numpy's
Philox generator, so the generated values are independent of device,
framework and backend: the port's rewrites and perturbations are the
reference's bit for bit.  ``generate_shard`` / ``extract_shard`` give a
rank its slices of the logical full tensor (``core.annotations``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.annotations import (ShardSpec, shard_concat_dim,
                                          slices_for_rank)
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


def generate_shard(cid, global_shape, spec: ShardSpec, sizes: dict,
                   coords: dict, dtype="float32", dist="normal",
                   scale: float = 1.0) -> np.ndarray:
    """The rank-local shard of the generated logical full tensor."""
    full = generate(cid, global_shape, dtype, dist, scale)
    return extract_shard(full, spec, sizes, coords)


def extract_shard(full: np.ndarray, spec: ShardSpec, sizes: dict,
                  coords: dict) -> np.ndarray:
    frags = slices_for_rank(spec, full.shape, sizes, coords)
    pieces = [full[f] for f in frags]
    if len(pieces) == 1:
        return pieces[0]
    cdim = shard_concat_dim(spec)
    if cdim is None:
        raise ValueError("multi-fragment shard without a concat dim")
    return np.concatenate(pieces, axis=cdim % full.ndim)


# normals drawn a chunk at a time: the float64 draw stays in cache for its
# cast, where one draw of the whole shape would allocate twice the output
_CHUNK = 1 << 20


def perturb_direction(shape, seed: int = 0, out: np.ndarray | None = None):
    """The half of ``perturb`` that does not depend on ``x``: the direction
    ``d`` (float64 normals of the Philox stream for ``seed``, cast to
    float32, into ``out`` if given) and ``||d||``.  Returns ``(d, nd)``."""
    rng = _rng(seed ^ 0x9E3779B97F4A7C15)
    d = np.empty(shape, np.float32) if out is None else out
    flat = d.reshape(-1)
    tmp = np.empty(min(_CHUNK, flat.size))
    for i in range(0, flat.size, _CHUNK):
        part = tmp[:min(_CHUNK, flat.size - i)]
        rng.standard_normal(out=part)
        np.copyto(flat[i:i + part.size], part)
    return d, np.linalg.norm(d)


def perturb_scale(nx, nd, rel_eps: float):
    """The half of ``perturb`` that depends on ``x`` through ``nx = ||x||``
    (float32): the scale of ``d``, or None where ``x`` or ``d`` is zero."""
    if nd == 0 or nx == 0:
        return None
    return rel_eps * nx / nd


def perturb(x: np.ndarray, rel_eps: float, seed: int = 0) -> np.ndarray:
    """x + dX with ||dX|| = rel_eps * ||x|| (threshold estimation, §5.2)."""
    d, nd = perturb_direction(x.shape, seed)
    x32 = x.astype(np.float32)
    s = perturb_scale(np.linalg.norm(x32), nd, rel_eps)
    if s is None:
        return x
    return (x32 + d * s).astype(x.dtype)

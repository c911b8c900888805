"""Production and host meshes: the port of ``repro/launch/mesh.py``.

A mesh here is its shape only (``ShapeMesh``: ``axis_names`` and a
``shape`` dict, as a ``jax.sharding.Mesh`` offers them): the sharding
rules (``sharding/rules.py``) read nothing else, and the dry run
(``launch/dryrun.py``) places nothing on it.  Building one touches no
device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ShapeMesh:
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """(16,16)=("data","model") single pod (256 chips) or
    (2,16,16)=("pod","data","model") two pods (512 chips)."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_host_mesh(model_parallel: int = 1) -> ShapeMesh:
    """("data","model") over the cards this host has, or one device where
    it has none: on one H100, (1,1)."""
    n = max(torch.cuda.device_count(), 1)
    mp = max(1, min(model_parallel, n))
    return ShapeMesh(("data", "model"), (n // mp, mp))

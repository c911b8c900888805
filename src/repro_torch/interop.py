"""Crossing between the port and the JAX reference package as numpy.

``params_from_jax`` loads the reference's parameters, given as numpy by
their ``collector.flatten_named`` names, into a port ``Model``;
``trace_to_numpy`` turns a port trace into numpy leaves the reference's
checker can read.  Neither imports JAX: the caller hands numpy across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collector import SECTION_FIELDS, Trace, to_numpy


def _as_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)      # ml_dtypes bfloat16 has no torch twin
    return torch.as_tensor(arr)


@torch.no_grad()
def params_from_jax(named: dict, model: torch.nn.Module) -> torch.nn.Module:
    """Copy ``{flat name: array}`` into ``model``'s parameters (cast to each
    parameter's dtype, on its device).  Names must match exactly."""
    params = dict(model.named_parameters())
    if set(params) != set(named):
        raise KeyError(f"parameter names differ: only in port "
                       f"{sorted(set(params) - set(named))}, only in source "
                       f"{sorted(set(named) - set(params))}")
    for name, p in params.items():
        src = _as_tensor(named[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(src.to(device=p.device, dtype=p.dtype))
    return model


def trace_to_numpy(trace: Trace) -> Trace:
    """A copy of ``trace`` whose leaves are host numpy (bf16 -> float32)."""
    out = Trace(loss=trace.loss, grad_norm=float(trace.grad_norm),
                meta=dict(trace.meta))
    for f in SECTION_FIELDS:
        setattr(out, f, {k: to_numpy(v) for k, v in
                         getattr(trace, f).raw_items()})
    return out

"""Batched rel-err engine — the checker's comparison core; the port of
``repro/core/relerr_engine.py``.

For N tensor pairs of a trace section, the N relative Frobenius errors come
from one reduction:

* **packed**: the pairs are packed into two block-aligned flat f32 buffers
  on their device and reduced by ``kernels.ops.packed_sq_norms`` — the
  hand-written CUDA kernel on the card (the TPU's role in the reference),
  its plain version for CPU tensors; N x 2 scalars reach the host;
* **loop**: below ``MIN_BATCHED_ELEMS`` total elements, a per-pair float64
  loop — the reference semantic, cheaper than packing a tiny section;
* **blas**: the reference's CPU executor, f32 dot products over zero-copy
  numpy views, for CPU tensors only.

The reference's **fused** mode (one compiled XLA reduction, its path on a
GPU backend) has no counterpart: on the card, ``packed`` does that job,
and both ``fused`` and ``blas`` on a CUDA tensor raise naming it.
``mode=None`` chooses between ``loop`` and ``packed`` by total size on
every device, where the reference picks ``loop`` or ``blas`` on its CPU.

``sq_norms_async`` is the asynchronous form the supervised loop uses: the
packed reduction is dispatched and its N x 2 result copied to pinned host
memory behind a CUDA event, and a ``NormsFuture`` stands for it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spans
from repro_torch.kernels import ops
from repro_torch.kernels.relerr import pack_device

# Below this many total section elements the float64 loop runs (the
# reference's TPU cutoff, which the card takes over).
MIN_BATCHED_ELEMS = 1 << 12


def rel_err_np(a, b) -> float:
    """Per-pair float64 reference: ||a-b|| / ||a|| (paper §2.2)."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    na = np.linalg.norm(a64)
    d = np.linalg.norm(a64 - b64)
    return float(d / na) if na > 0 else float(d)


def _raw(section, name):
    """Stored leaf without forcing a host copy (Section.raw or dict item)."""
    getter = getattr(section, "raw", None)
    return getter(name) if getter is not None else section[name]


def _packed_path(leaves_a, leaves_b) -> np.ndarray:
    with spans.span("pack", alloc=True):
        a_flat, b_flat, seg_ids, counts = pack_device(leaves_a, leaves_b)
    with spans.span("reduce"):
        out = ops.packed_sq_norms(a_flat, b_flat, seg_ids, counts,
                                  n_segments=len(leaves_a))
        return out.cpu().numpy().astype(np.float64)


def _loop_path(leaves_a, leaves_b) -> np.ndarray:
    rows = []
    for a, b in zip(leaves_a, leaves_b):
        a64 = a.detach().reshape(-1).double()
        d = a64 - b.detach().reshape(-1).double()
        rows.append(torch.stack([torch.dot(d, d), torch.dot(a64, a64)]))
    return torch.stack(rows).cpu().numpy()


def _blas_path(leaves_a, leaves_b) -> np.ndarray:
    """CPU executor: f32 BLAS over zero-copy views of the leaves."""
    def as_f32(x):
        return x.detach().reshape(-1).float().numpy()

    out = np.empty((len(leaves_a), 2), np.float64)
    scratch = np.empty(max(int(x.numel()) for x in leaves_a), np.float32)
    for i, (a, b) in enumerate(zip(leaves_a, leaves_b)):
        an, bn = as_f32(a), as_f32(b)
        d = scratch[:an.size]
        np.subtract(an, bn, out=d)
        out[i, 0] = np.dot(d, d)
        out[i, 1] = np.dot(an, an)
    return out


def section_sq_norms(leaves_a, leaves_b, mode: str | None = None
                     ) -> np.ndarray:
    """(N, 2) float64 of ``(||a-b||^2, ||a||^2)`` per pair of tensors.

    ``mode``: None (auto by size), "loop", "packed", or "blas" (CPU
    tensors); "fused" and "blas" on the card raise, naming "packed".
    """
    if not leaves_a:
        return np.zeros((0, 2), np.float64)
    if mode is None:
        total = sum(int(x.numel()) for x in leaves_a)
        mode = "loop" if total < MIN_BATCHED_ELEMS else "packed"
    if mode == "loop":
        return _loop_path(leaves_a, leaves_b)
    if mode == "packed":
        return _packed_path(leaves_a, leaves_b)
    if mode == "fused":
        raise ValueError("rel-err mode 'fused' is the reference's one XLA "
                         "reduction; on the card mode 'packed' does its job")
    if mode == "blas":
        if any(x.device.type != "cpu" for x in (*leaves_a, *leaves_b)):
            raise ValueError("rel-err mode 'blas' runs on CPU tensors; on "
                             "the card use mode 'packed'")
        return _blas_path(leaves_a, leaves_b)
    raise ValueError(f"unknown rel-err engine mode {mode!r}")


class NormsFuture:
    """The (N, 2) result of ``sq_norms_async``: ``is_ready()`` probes its
    CUDA event without waiting; ``np.asarray(future)`` waits on the event
    and returns the host array.  A future over CPU tensors is resolved
    when made."""

    def __init__(self, host: torch.Tensor, event=None):
        self._host = host
        self._event = event

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype)


def sq_norms_async(leaves_a, leaves_b) -> NormsFuture:
    """Dispatch the per-pair ``(||a-b||^2, ||a||^2)`` reduction and return
    a ``NormsFuture`` without waiting for the device.

    On CUDA tensors: ``pack_device``, one ``packed_sq_norms`` launch, and a
    non-blocking copy of the (N, 2) result into pinned host memory behind
    a recorded event.  On CPU tensors the same packed reduction runs (its
    plain version) and the future is already resolved."""
    if not leaves_a:
        return NormsFuture(torch.zeros((0, 2), dtype=torch.float32))
    a_flat, b_flat, seg_ids, counts = pack_device(leaves_a, leaves_b)
    out = ops.packed_sq_norms(a_flat, b_flat, seg_ids, counts,
                              n_segments=len(leaves_a))
    if out.device.type != "cuda":
        return NormsFuture(out)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return NormsFuture(host, event)


def _to_rel_err(sq: np.ndarray) -> np.ndarray:
    d = np.sqrt(sq[:, 0])
    na = np.sqrt(sq[:, 1])
    return np.where(na > 0, d / np.maximum(na, 1e-300), d)


def batched_rel_err(section_a, section_b, names=None,
                    mode: str | None = None) -> dict[str, float]:
    """Relative Frobenius errors for every pair in a trace section.

    ``names`` defaults to the keys of ``section_a`` present in ``section_b``
    (in ``section_a`` order); pairs must be same-shaped.
    """
    if names is None:
        names = [k for k in section_a if k in section_b]
    leaves_a = [_raw(section_a, n) for n in names]
    leaves_b = [_raw(section_b, n) for n in names]
    errs = _to_rel_err(section_sq_norms(leaves_a, leaves_b, mode=mode))
    return {n: float(e) for n, e in zip(names, errs)}

"""Batched rel-err engine — the checker's comparison core; the port of
``repro/core/relerr_engine.py``.

For N tensor pairs of a trace section, the N relative Frobenius errors come
from one reduction:

* **packed**: the pairs are packed into two block-aligned flat f32 buffers
  on their device and reduced by ``kernels.ops.packed_sq_norms`` — the
  hand-written CUDA kernel on the card (the TPU's role in the reference),
  its plain version for CPU tensors; N x 2 scalars reach the host;
* **loop**: below ``MIN_BATCHED_ELEMS`` total elements, a per-pair float64
  loop — the reference semantic, cheaper than packing a tiny section.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.relerr import DEFAULT_BLOCK

# Below this many total section elements the float64 loop runs (the
# reference's TPU cutoff, which the card takes over).
MIN_BATCHED_ELEMS = 1 << 12


def _raw(section, name):
    """Stored leaf without forcing a host copy (Section.raw or dict item)."""
    getter = getattr(section, "raw", None)
    return getter(name) if getter is not None else section[name]


def pack_device(leaves_a, leaves_b, block: int = DEFAULT_BLOCK):
    """Pack pairs into the kernel's flat block-aligned f32 layout on the
    leaves' device.  Returns (a_flat, b_flat, seg_ids, counts); see
    ``kernels.relerr`` for the layout contract.  Metadata is computed
    host-side from shapes — no leaf is transferred."""
    sizes = [int(x.numel()) for x in leaves_a]
    nblocks = [max(1, -(-s // block)) for s in sizes]
    device = leaves_a[0].device
    total = sum(nblocks) * block
    flats = []
    for leaves in (leaves_a, leaves_b):
        flat = torch.zeros(total, dtype=torch.float32, device=device)
        off = 0
        for x, s, nb in zip(leaves, sizes, nblocks):
            flat[off:off + s].copy_(x.reshape(-1))
            off += nb * block
        flats.append(flat)
    seg_ids = np.repeat(np.arange(len(sizes), dtype=np.int32), nblocks)
    counts = np.concatenate([
        np.clip(s - np.arange(nb, dtype=np.int64) * block, 0, block)
        for s, nb in zip(sizes, nblocks)]).astype(np.int32)
    return (flats[0], flats[1], torch.from_numpy(seg_ids).to(device),
            torch.from_numpy(counts).to(device))


def _packed_path(leaves_a, leaves_b) -> np.ndarray:
    a_flat, b_flat, seg_ids, counts = pack_device(leaves_a, leaves_b)
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


def section_sq_norms(leaves_a, leaves_b, mode: str | None = None
                     ) -> np.ndarray:
    """(N, 2) float64 of ``(||a-b||^2, ||a||^2)`` per pair of tensors.

    ``mode``: None (auto by size), "loop" or "packed".
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
    raise ValueError(f"unknown rel-err engine mode {mode!r}")


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

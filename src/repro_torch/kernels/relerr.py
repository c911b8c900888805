"""Packed segmented rel-err reduction: the port of
``repro/kernels/relerr.py::packed_sq_norms``.

Layout contract (produced by ``pack_device``, the same as the
reference's):

* each pair's elements are flattened to f32 and placed at a
  ``block``-aligned offset; the tail of its last block is zero-filled,
* ``seg_ids[i]`` is the pair owning block i; a pair's blocks are
  contiguous and ``seg_ids`` is non-decreasing,
* ``counts[i]`` is the number of valid elements in block i; the padding is
  masked by select, so NaN garbage there can never leak into a verdict,
  while a NaN in a real element propagates.

The block stays the reference's 1024 elements: on Hopper it is one float4
load for each of 256 threads, and the tests compare layouts at one block.

``packed_sq_norms`` takes the hand-written CUDA kernel
(``csrc/relerr.cu``) for CUDA tensors and its plain version,
``packed_sq_norms_ref``, for CPU tensors only; a CUDA tensor launches the
kernel or raises.  ``packed_sq_norms.launches`` counts kernel launches.

The single-pair wrappers (``sq_norms``, ``rel_err_fused``) are one launch
of the same kernel over one segment at ``SINGLE_PAIR_BLOCK`` elements a
block, the reference's: with one pair there is no alignment waste, and
each of the kernel's 256 threads loops over 64 float4 loads a block.
``rel_err_ref`` is their plain float64 version.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

DEFAULT_BLOCK = 1024
SINGLE_PAIR_BLOCK = 65536

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib():
    from repro_torch.kernels import build
    lib = build.load("relerr")
    fn = lib.repro_packed_sq_norms
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(a_flat, b_flat, seg_ids, counts, n_segments, block):
    if a_flat.dtype != torch.float32 or b_flat.dtype != torch.float32:
        raise TypeError("packed buffers must be float32")
    if seg_ids.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("seg_ids and counts must be int32")
    if not (a_flat.dim() == b_flat.dim() == seg_ids.dim() == counts.dim() == 1):
        raise ValueError("packed buffers and metadata must be 1-D")
    if block <= 0 or block % 4:
        raise ValueError(f"block {block} must be a positive multiple of 4")
    nb = a_flat.shape[0] // block
    if (a_flat.shape[0] != nb * block or b_flat.shape != a_flat.shape
            or seg_ids.shape[0] != nb or counts.shape[0] != nb):
        raise ValueError("packed shapes disagree with the block layout")
    if n_segments < 1:
        raise ValueError("n_segments must be >= 1")
    devices = {t.device for t in (a_flat, b_flat, seg_ids, counts)}
    if len(devices) != 1:
        raise ValueError(f"packed tensors span devices {devices}")
    return nb


@functools.lru_cache(maxsize=64)
def _segments(sizes: tuple, block: int, device: torch.device):
    """``(seg_ids, counts)`` of a packed section on ``device``.  Computed
    host-side from the sizes and copied once per layout: a section's
    layout repeats every step, and a copy per call would wait for the
    device."""
    nblocks = [max(1, -(-s // block)) for s in sizes]
    seg_ids = np.repeat(np.arange(len(sizes), dtype=np.int32), nblocks)
    counts = np.concatenate([
        np.clip(s - np.arange(nb, dtype=np.int64) * block, 0, block)
        for s, nb in zip(sizes, nblocks)]).astype(np.int32)
    return (torch.from_numpy(seg_ids).to(device),
            torch.from_numpy(counts).to(device))


def pack_device(leaves_a, leaves_b, block: int = DEFAULT_BLOCK):
    """Pack pairs into the kernel's flat block-aligned f32 layout on the
    leaves' device.  Returns (a_flat, b_flat, seg_ids, counts), the
    layout contract above.  Metadata is computed host-side from shapes —
    no leaf is transferred."""
    sizes = tuple(int(x.numel()) for x in leaves_a)
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
    seg_ids, counts = _segments(sizes, block, device)
    return flats[0], flats[1], seg_ids, counts


def packed_sq_norms_ref(a_flat, b_flat, seg_ids, counts, n_segments: int,
                        block: int = DEFAULT_BLOCK):
    """Plain PyTorch version of the kernel: per-block masked f32 sums, then
    per-segment float64 sums.  -> (n_segments, 2) f32."""
    nb = a_flat.shape[0] // block
    a = a_flat.reshape(nb, block)
    b = b_flat.reshape(nb, block)
    valid = (torch.arange(block, device=a.device)[None, :]
             < counts[:, None].to(a.device))
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    d = torch.where(valid, a - b, zero)
    a = torch.where(valid, a, zero)
    part = torch.stack([torch.sum(d * d, dim=1), torch.sum(a * a, dim=1)], dim=1)
    # per-segment sums in float64, as the kernel's second stage
    out = torch.zeros((n_segments, 2), dtype=torch.float64, device=a.device)
    return out.index_add_(0, seg_ids.long(), part.double()).float()


def packed_sq_norms(a_flat, b_flat, seg_ids, counts, n_segments: int,
                    block: int = DEFAULT_BLOCK):
    """One launch over the packed section -> (n_segments, 2) f32 of
    ``(||a-b||^2, ||a||^2)`` per pair."""
    nb = _check(a_flat, b_flat, seg_ids, counts, n_segments, block)
    dev = a_flat.device
    if dev.type == "cpu":
        return packed_sq_norms_ref(a_flat, b_flat, seg_ids, counts,
                                   n_segments, block)
    if dev.type != "cuda":
        raise ValueError(f"packed_sq_norms runs on cuda or cpu, not {dev}")
    tensors = (a_flat, b_flat, seg_ids, counts)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("packed tensors must be contiguous")
    if a_flat.data_ptr() % 16 or b_flat.data_ptr() % 16:
        raise ValueError("packed buffers must be 16-byte aligned")
    fn = _lib()
    partial = torch.empty((nb, 2), dtype=torch.float32, device=dev)
    out = torch.empty((n_segments, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(a_flat.data_ptr(), b_flat.data_ptr(), seg_ids.data_ptr(),
                counts.data_ptr(), partial.data_ptr(), out.data_ptr(), nb,
                block, n_segments, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_sq_norms kernel launch failed: CUDA error {rc}")
    packed_sq_norms.launches += 1
    return out


packed_sq_norms.launches = 0


# ---------------------------------------------------------------------------
# single-pair wrappers
# ---------------------------------------------------------------------------

def single_pair_layout(a, b, block: int = SINGLE_PAIR_BLOCK):
    """``pack_device`` of the one pair (a, b): each leaf flattened into a
    new, zero-padded f32 buffer of whole blocks (bf16 or strided leaves
    are copied the same way), one block for an empty pair."""
    if a.numel() != b.numel():
        raise ValueError(f"pair sizes differ: {a.numel()} and {b.numel()}")
    return pack_device([a.detach()], [b.detach()], block)


def sq_norms(a, b, block: int = SINGLE_PAIR_BLOCK):
    """``(||a-b||^2, ||a||^2)`` for ONE pair as two 0-d f32 tensors on its
    device: one ``packed_sq_norms`` launch over a single segment."""
    out = packed_sq_norms(*single_pair_layout(a, b, block), n_segments=1,
                          block=block)
    return out[0, 0], out[0, 1]


def rel_err_fused(a, b) -> float:
    """||a-b|| / ||a|| of one pair through the kernel; ||a-b|| where
    ||a|| = 0."""
    d2, a2 = sq_norms(a, b)
    d2, a2 = float(d2), float(a2)
    return (d2 ** 0.5) / (a2 ** 0.5) if a2 > 0 else d2 ** 0.5


def rel_err_ref(a, b) -> float:
    """Plain float64 version of ``rel_err_fused``."""
    a64 = torch.as_tensor(a).detach().reshape(-1).double()
    d = a64 - torch.as_tensor(b).detach().reshape(-1).to(a64)
    na = float(torch.linalg.vector_norm(a64))
    nd = float(torch.linalg.vector_norm(d))
    return nd / na if na > 0 else nd

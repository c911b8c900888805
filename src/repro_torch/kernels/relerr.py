"""Packed segmented rel-err reduction: the port of
``repro/kernels/relerr.py::packed_sq_norms``.

Layout contract (produced by ``core.relerr_engine.pack_device``, the same
as the reference's):

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
"""
from __future__ import annotations

import ctypes

import torch

DEFAULT_BLOCK = 1024

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

"""Tiled e4m3 x e4m3 -> f32 matmuls: the port of
``repro/kernels/fp8_matmul.py``.

* ``fp8_matmul(x, w)`` — operands arrive quantized (``float8_e4m3fn``);
  the recipe's one scale per operand is applied outside, by
  ``precision.fp8``.  Shape contract, the reference's with its default
  256 blocks: each of M, N and K divides by ``min(256, dim)``.
* ``fp8_matmul_tile128(x, sx, w, sw)`` — the DeepSeek-V3 recipe: compact
  per-128x128-tile scales ride along and each 128-deep K block's partial
  product is scaled by ``sx[mi,ki] * sw[ki,ni]`` before it joins the f32
  accumulator.  Every dim is a multiple of 128; sx is (M/128, K/128) and
  sw (K/128, N/128), f32.

Both take x (M,K) and w (K,N) row-major and return (M,N) f32.  On CUDA
tensors they launch the hand-written kernel (``csrc/fp8_matmul.cu``, one
source for both) or raise; on CPU tensors they run their plain versions,
``fp8_matmul_ref`` and ``fp8_matmul_tile128_ref``.  ``.launches`` on each
wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

F8 = torch.float8_e4m3fn
TILE = 128
BLOCK = 256          # the reference kernel's default block

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    from repro_torch.kernels import build
    fn = build.load("fp8_matmul").repro_fp8_matmul
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_operands(x, w):
    if x.dtype != F8 or w.dtype != F8:
        raise TypeError(f"operands must be float8_e4m3fn, got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x (M,K) and w (K,N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    return x.shape[0], w.shape[1], x.shape[1]


def _check_tile_scales(x, sx, w, sw):
    M, N, K = _check_operands(x, w)
    if M % TILE or N % TILE or K % TILE:
        raise ValueError(f"tile128 needs every dim a multiple of {TILE}, got "
                         f"M={M} N={N} K={K}")
    if tuple(sx.shape) != (M // TILE, K // TILE):
        raise ValueError(f"sx shape {tuple(sx.shape)} for x {tuple(x.shape)}")
    if tuple(sw.shape) != (K // TILE, N // TILE):
        raise ValueError(f"sw shape {tuple(sw.shape)} for w {tuple(w.shape)}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise TypeError("tile scales must be float32")
    return M, N, K


def fp8_matmul_ref(x, w):
    """Plain PyTorch version of ``fp8_matmul``: upcast, f32 product."""
    return x.float() @ w.float()


def fp8_matmul_tile128_ref(x, sx, w, sw):
    """Plain PyTorch version of ``fp8_matmul_tile128``: the kernel's
    arithmetic, ``acc + (sx * sw) * partial`` per 128-deep K block."""
    M, N, K = _check_tile_scales(x, sx, w, sw)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for ki in range(K // TILE):
        k = slice(ki * TILE, (ki + 1) * TILE)
        part = x[:, k].float() @ w[k, :].float()
        s = sx[:, ki, None] * sw[None, ki, :]                   # (M/128, N/128)
        s = s.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
        acc = acc + s * part
    return acc


def _launch(x, w, sx, sw, tile_scaled: bool, name: str):
    dev = x.device
    tensors = [x, w] + ([sx, sw] if tile_scaled else [])
    if {t.device for t in tensors} != {dev}:
        raise ValueError(f"{name}: operands span devices "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib()(x.data_ptr(), w.data_ptr(),
                    sx.data_ptr() if tile_scaled else None,
                    sw.data_ptr() if tile_scaled else None,
                    out.data_ptr(), M, N, K, int(tile_scaled),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out


def _route(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def fp8_matmul(x, w):
    """x: (M,K) e4m3 @ w: (K,N) e4m3 -> (M,N) f32."""
    M, N, K = _check_operands(x, w)
    for dim, n in (("M", M), ("N", N), ("K", K)):
        if n == 0 or n % min(BLOCK, n):
            raise ValueError(f"fp8_matmul: {dim}={n} is not a multiple of "
                             f"min({BLOCK}, {dim})")
    if _route(x, "fp8_matmul") == "cpu":
        return fp8_matmul_ref(x, w)
    out = _launch(x, w, None, None, False, "fp8_matmul")
    fp8_matmul.launches += 1
    return out


def fp8_matmul_tile128(x, sx, w, sw):
    """Per-128x128-tile-scaled x @ w -> (M,N) f32, the dequantized
    operands never materialized."""
    _check_tile_scales(x, sx, w, sw)
    if _route(x, "fp8_matmul_tile128") == "cpu":
        return fp8_matmul_tile128_ref(x, sx, w, sw)
    out = _launch(x, w, sx, sw, True, "fp8_matmul_tile128")
    fp8_matmul_tile128.launches += 1
    return out


fp8_matmul.launches = 0
fp8_matmul_tile128.launches = 0

"""Online-softmax GQA attention, forward only: the port of
``repro/kernels/flash_attention.py``.

``flash_attention(q, k, v, mode, window, bq, bk)`` takes q (B,S,H,D) and
k, v (B,S,Hkv,D) in f32 or bf16 and returns (B,S,H,D) in q's dtype; query
head h reads kv head ``h // (H/Hkv)``.  Modes are ``causal``, ``swa`` (k <=
q and k > q - window) and ``bidirectional``.  ``bq`` and ``bk`` are the
reference's shape contract, not the CUDA tile: with ``bq = min(bq, S)``
(and the same for ``bk``), S must divide by both.

On CUDA tensors the forward launches a hand-written kernel or raises; on
CPU tensors it runs the plain version, ``flash_attention_ref`` (the
model's ``attention_ref``).  The kernel is chosen by dtype alone
(``ENTRY_POINTS``): bf16 runs on the TMA + wgmma kernel
(``csrc/flash_attention_wgmma.cu``), f32 on the FMA kernel
(``csrc/flash_attention.cu``), and neither gives way to the other or to
the plain version.  Both read the tensors in place through their strides:
the head dim must have stride 1; f32 rows must start on 4-element
boundaries, bf16 rows (for TMA) on 16-byte ones, with 16-byte aligned
bases.  D is 64, 80, 112 or 128 (the reference configs' head dims: 80 in
qwen3-32b and hubert-xlarge, 112 in zamba2-7b's shared block), read in
place at every D, with no padded copy.  ``flash_attention.launches``
counts kernel launches.

The TPU kernel has no backward, and the reference cannot differentiate
through it.  The backward here is not a kernel: it is the gradient of the
model's own non-kernel attention (``attention_ref`` up to S = 2048,
``attention_blockwise`` above), recomputed from the saved q, k and v.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.models.attention import attention_ref

MODES = {"causal": 0, "swa": 1, "bidirectional": 2}
HEAD_DIMS = (64, 80, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)

# (source in csrc/, C entry point) of the kernel for each dtype; both take
# _ARGTYPES
ENTRY_POINTS = {
    torch.bfloat16: ("flash_attention_wgmma", "repro_flash_attention_wgmma"),
    torch.float32: ("flash_attention", "repro_flash_attention_fma"),
}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


# what the bf16 kernel's profiled build (``profile``) times, in SM cycles of
# one consumer warpgroup (csrc/flash_attention_wgmma.cu, ``Phase``)
PHASES = ("load", "turn", "qk", "softmax", "pv", "pack", "total")


def _lib(source, symbol, argtypes=_ARGTYPES):
    from repro_torch.kernels import build
    fn = getattr(build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_contract(q, k, v, mode, bq=512, bk=512):
    """The reference's shape contract (both devices); raises otherwise."""
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}; known: "
                         f"{sorted(MODES)}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B,S,H,D)")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B,S,Hkv,D) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    for name, blk in (("bq", bq), ("bk", bk)):
        blk = min(blk, S)
        if blk <= 0 or S % blk:
            raise ValueError(f"S={S} is not a multiple of {name}={blk}")


def check_kernel_operands(q, k, v):
    """What the CUDA kernel takes beyond the contract; raises otherwise."""
    D = q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    # f32: float4 loads; bf16: TMA (16-byte aligned base and strides)
    elems = 4 if q.dtype == torch.float32 else 8
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous, got "
                             f"strides {t.stride()}")
        if any(s % elems for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must start on {elems}-element "
                             f"(16-byte) boundaries from a 16-byte aligned "
                             f"base, got strides {t.stride()} at address "
                             f"{t.data_ptr():#x}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs q, k and v on one "
                         f"CUDA device, got {sorted(map(str, devices))}")


def flash_attention_ref(q, k, v, mode="causal", window=0, bq=512, bk=512):
    """Plain PyTorch version: ``attention_ref`` under the same contract."""
    check_contract(q, k, v, mode, bq, bk)
    return attention_ref(q, k, v, mode=mode, window=window)


def _args(q, k, v, out, mode, window):
    """The entry points' arguments before the profile buffer and stream."""
    B, S, H, D = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], MODES[mode], int(window), 1.0 / math.sqrt(D))


def _run(q, k, v, out, mode, window, stream):
    """One launch of the kernel of q's dtype on ``stream``; raises on a
    non-zero return code, with no second attempt."""
    source, symbol = ENTRY_POINTS[q.dtype]
    rc = _lib(source, symbol)(*_args(q, k, v, out, mode, window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel {symbol} failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1


def _launch(q, k, v, mode, window):
    check_kernel_operands(q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    dev = q.device
    with torch.cuda.device(dev):
        _run(q, k, v, out, mode, window,
             torch.cuda.current_stream(dev).cuda_stream)
    return out


def profile(q, k, v, mode="causal", window=0):
    """One launch of the bf16 kernel's profiled build (not counted in
    ``flash_attention.launches``): an int64 tensor of (blocks of 128 q rows
    x 2 consumer warpgroups, len(PHASES)) SM cycles per warpgroup and
    phase."""
    check_contract(q, k, v, mode)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the profiled kernel is the bf16 one, got {q.dtype}")
    check_kernel_operands(q, k, v)
    B, S, H, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    prof = torch.zeros((B * H * -(-S // 128) * 2, len(PHASES)),
                       dtype=torch.int64, device=q.device)
    fn = _lib(ENTRY_POINTS[q.dtype][0], "repro_flash_attention_wgmma_profile",
              _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        rc = fn(*_args(q, k, v, out, mode, window), prof.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"profiled flash_attention kernel failed: CUDA "
                           f"error {rc}")
    return prof


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU).  Backward:
    the reference's attention gradient, recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, mode, window):
        ctx.save_for_backward(q, k, v)
        ctx.mode, ctx.window = mode, window
        if q.device.type == "cpu":
            return attention_ref(q, k, v, mode=mode, window=window)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cuda or cpu, not "
                             f"{q.device}")
        return _launch(q, k, v, mode, window)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import attention
        saved = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True) for t in saved)
            o = attention(q, k, v, mode=ctx.mode, window=ctx.window)
        gq, gk, gv = torch.autograd.grad(o, (q, k, v), g)
        return gq, gk, gv, None, None


def flash_attention(q, k, v, mode="causal", window=0, bq=512, bk=512):
    """q: (B,S,H,D); k/v: (B,S,Hkv,D).  Returns (B,S,H,D) in q's dtype."""
    check_contract(q, k, v, mode, bq, bk)
    return _FlashAttention.apply(q, k, v, mode, window)


flash_attention.launches = 0

"""Chunked gated-linear-attention scan (Mamba2 SSD / RWKV-6 core): the port
of ``repro/kernels/ssm_scan.py``.

``gla_scan(q, k, v, log_w, chunk, exclusive)`` takes q, k (B,S,H,dk), v
(B,S,H,dv) and log_w (B,S,H,dk) (per-channel decay, rwkv6) or (B,S,H,1)
(scalar decay, mamba2), and returns y (B,S,H,dv) and the final state
(B,H,dk,dv), both f32.  ``exclusive`` reads S_{t-1} instead of S_t.  The
reference's contract: ``chunk = min(chunk, S)`` and S % chunk == 0.

On CUDA tensors the forward launches the hand-written kernel
(``csrc/ssm_scan.cu``) or raises; on CPU tensors it runs the plain version,
``gla_scan_ref`` (the model's chunked math, ``models.ssm.chunk_scan``).
The kernel reads the tensors in place through their strides (the last dim
contiguous); q, k and v share f32 or bf16, log_w is f32; dk, dv and the
chunk are at most 128.  It runs in three passes on the stream (each
chunk's k_dec^T v; the fold over chunks; each chunk's y, on the tensor
cores in split TF32), through scratch the wrapper allocates
(``scratch_shapes``); one wrapper call counts as one launch in
``gla_scan.launches``.

The TPU kernel has no backward.  The backward here is not a kernel: it is
the gradient of the plain chunked math, recomputed from the saved q, k, v
and log_w, for all four (RWKV-6's decay is data-dependent and trained).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.ssm import chunk_scan

MAX_DIM = 128                   # dk, dv and chunk the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
# what the profiled build (``profile``) times in each pass, in SM cycles of
# a block (csrc/ssm_scan.cu, ``StatePhase`` and ``OutPhase``); the fold
# times its blocks whole
PASSES = ("state", "fold", "out")
PHASES = {"state": ("stage", "mma", "store", "total", "stage_k",
                    "stage_v"),
          "fold": ("total",),
          "out": ("stage", "qk", "v", "y", "store", "total", "stage_qk",
                  "stage_s")}
PROFILE_SLOTS = 8               # int64 per block in the profile
FOLD_THREADS = 256

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
_PROFILE_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p] * 3


def _lib(symbol="repro_gla_scan", argtypes=_ARGTYPES):
    from repro_torch.kernels import build
    fn = getattr(build.load("ssm_scan"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_contract(q, k, v, log_w, chunk):
    """The reference's shape contract (both devices); returns the chunk
    the scan uses, ``min(chunk, S)``; raises otherwise."""
    if any(t.dim() != 4 for t in (q, k, v, log_w)):
        raise ValueError("q, k, v and log_w must be (B,S,H,d)")
    B, S, H, dk = q.shape
    if tuple(k.shape) != (B, S, H, dk):
        raise ValueError(f"k must be {tuple(q.shape)}, got {tuple(k.shape)}")
    if tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"v must be (B,S,H,dv) beside q {tuple(q.shape)}, "
                         f"got {tuple(v.shape)}")
    if tuple(log_w.shape[:3]) != (B, S, H) or log_w.shape[3] not in (1, dk):
        raise ValueError(f"log_w must be (B,S,H,1) or (B,S,H,{dk}), got "
                         f"{tuple(log_w.shape)}")
    if not all(t.is_floating_point() for t in (q, k, v, log_w)):
        raise TypeError("q, k, v and log_w must be floating point")
    chunk = min(chunk, S)
    if chunk <= 0 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    return chunk


def check_kernel_operands(q, k, v, log_w, chunk):
    """What the CUDA kernel takes beyond the contract; raises otherwise."""
    dk, dv = q.shape[3], v.shape[3]
    if dk > MAX_DIM or dv > MAX_DIM or chunk > MAX_DIM:
        raise ValueError(f"gla_scan kernel takes dk, dv and chunk up to "
                         f"{MAX_DIM}, got {dk}, {dv} and {chunk}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype} and {v.dtype}")
    if log_w.dtype != torch.float32:
        raise TypeError(f"log_w must be float32, got {log_w.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("log_w", log_w)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous, got "
                             f"strides {t.stride()}")
    devices = {t.device for t in (q, k, v, log_w)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"gla_scan kernel needs q, k, v and log_w on one "
                         f"CUDA device, got {sorted(map(str, devices))}")


def _rows_16_byte(t):
    """Every row of ``t`` (B,S,H,d) starts on a 16-byte boundary and is a
    whole number of 16-byte pieces."""
    n = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[3] % n == 0
            and all(st % n == 0 for st in t.stride()[:3]))


def staging_vec(q, k, v, log_w) -> bool:
    """Whether the kernel may stage with 16-byte loads: every row of q, k,
    v (and of a per-channel log_w) starts on 16 bytes and is whole 16-byte
    pieces."""
    return (all(_rows_16_byte(t) for t in (q, k, v))
            and (log_w.shape[3] == 1 or _rows_16_byte(log_w)))


def gla_scan_ref(q, k, v, log_w, chunk=128, exclusive=False):
    """Plain PyTorch version: the kernel's chunked math in f32 (float64 for
    float64 inputs), under the same contract."""
    chunk = check_contract(q, k, v, log_w, chunk)
    return chunk_scan(q, k, v, log_w, chunk, exclusive=exclusive)


def scratch_shapes(B, S, H, dk, dv, dw, chunk):
    """Shapes of the kernel's f32 scratch, chunk-major as its blocks run:
    each chunk's k_dec^T v, then the state it starts from, (S / chunk, B,
    H, dk, dv rounded up to 4); and exp(L_C), (S / chunk, B, H, dw)."""
    n = S // chunk
    return (n, B, H, dk, -(-dv // 4) * 4), (n, B, H, dw)


def profile_blocks(B, S, H, dk, dv, chunk):
    """Blocks of each pass, in the profile's order (``PASSES``)."""
    chunks = B * H * (S // chunk)
    return {"state": chunks * -(-dk // 64),
            "fold": -(-B * H * dk * dv // FOLD_THREADS), "out": chunks}


def _flags(q, k, v, log_w, exclusive):
    return (int(exclusive) | (int(q.dtype == torch.bfloat16) << 1)
            | (int(staging_vec(q, k, v, log_w)) << 2))


def _args(q, k, v, log_w, chunk, exclusive, y, s_fin, kv, decay):
    B, S, H, dk = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), kv.data_ptr(), decay.data_ptr(),
            B, S, H, dk, v.shape[3], log_w.shape[3], chunk,
            _flags(q, k, v, log_w, exclusive), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *log_w.stride()[:3])


def _outputs(q, v, log_w, chunk):
    B, S, H, dk = q.shape
    dv, dev = v.shape[3], q.device
    kv_shape, decay_shape = scratch_shapes(B, S, H, dk, dv, log_w.shape[3],
                                           chunk)
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((B, S, H, dv), (B, H, dk, dv), kv_shape,
                               decay_shape))


def _run(q, k, v, log_w, chunk, exclusive, y, s_fin, kv, decay, stream):
    """One launch (the three passes) on ``stream``; raises on a non-zero
    return code, with no second attempt."""
    rc = _lib()(*_args(q, k, v, log_w, chunk, exclusive, y, s_fin, kv,
                       decay), stream)
    if rc != 0:
        raise RuntimeError(f"gla_scan kernel launch failed: CUDA error {rc}")
    gla_scan.launches += 1


def _launch(q, k, v, log_w, chunk, exclusive):
    check_kernel_operands(q, k, v, log_w, chunk)
    y, s_fin, kv, decay = _outputs(q, v, log_w, chunk)
    with torch.cuda.device(q.device):
        _run(q, k, v, log_w, chunk, exclusive, y, s_fin, kv, decay,
             torch.cuda.current_stream(q.device).cuda_stream)
    return y, s_fin


def profile(q, k, v, log_w, chunk=128, exclusive=False):
    """One launch of the profiled build (not counted in
    ``gla_scan.launches``; it synchronizes).  Returns (y, s_final, cycles,
    pass_ms): ``cycles`` maps each pass to an int64 tensor of (blocks,
    len(PHASES[pass])) SM cycles of each block's phases, ``pass_ms`` each
    pass's time in ms (CUDA events)."""
    chunk = check_contract(q, k, v, log_w, chunk)
    check_kernel_operands(q, k, v, log_w, chunk)
    B, S, H, dk = q.shape
    blocks = profile_blocks(B, S, H, dk, v.shape[3], chunk)
    prof = torch.zeros((sum(blocks.values()), PROFILE_SLOTS),
                       dtype=torch.int64, device=q.device)
    pass_ms = torch.zeros(len(PASSES), dtype=torch.float32)
    y, s_fin, kv, decay = _outputs(q, v, log_w, chunk)
    with torch.cuda.device(q.device):
        rc = _lib("repro_gla_scan_profile", _PROFILE_ARGTYPES)(
            *_args(q, k, v, log_w, chunk, exclusive, y, s_fin, kv, decay),
            prof.data_ptr(), pass_ms.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"profiled gla_scan kernel failed: CUDA error "
                           f"{rc}")
    cycles, at = {}, 0
    for name in PASSES:
        n = blocks[name]
        cycles[name] = prof[at:at + n, :len(PHASES[name])]
        at += n
    return y, s_fin, cycles, dict(zip(PASSES, pass_ms.tolist()))


def shared_memory(dtype, scalar, dv, chunk):
    """Dynamic shared memory of a state-pass and an out-pass block, in
    bytes."""
    fn = _lib("repro_gla_scan_smem", [ctypes.c_int] * 5)
    return {name: fn(pas, int(dtype == torch.bfloat16), int(scalar), dv,
                     chunk) for name, pas in (("state", 1), ("out", 3))}


class _GLAScan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU).  Backward:
    the gradient of the plain chunked math, recomputed from q, k, v and
    log_w; a zero or absent gradient of the final state is taken."""

    @staticmethod
    def forward(ctx, q, k, v, log_w, chunk, exclusive):
        ctx.save_for_backward(q, k, v, log_w)
        ctx.chunk, ctx.exclusive = chunk, exclusive
        ctx.set_materialize_grads(False)
        if q.device.type == "cpu":
            return chunk_scan(q, k, v, log_w, chunk, exclusive=exclusive)
        if q.device.type != "cuda":
            raise ValueError(f"gla_scan runs on cuda or cpu, not {q.device}")
        return _launch(q, k, v, log_w, chunk, exclusive)

    @staticmethod
    def backward(ctx, gy, gs):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = tuple(t.detach().requires_grad_(True) for t in saved)
            y, s = chunk_scan(*ins, ctx.chunk, exclusive=ctx.exclusive)
        outs = [(o, g) for o, g in ((y, gy), (s, gs)) if g is not None]
        if not outs:
            return None, None, None, None, None, None
        # the final state does not depend on q
        grads = torch.autograd.grad([o for o, _ in outs], ins,
                                    [g for _, g in outs], allow_unused=True)
        return (*grads, None, None)


def gla_scan(q, k, v, log_w, chunk=128, exclusive=False):
    """Returns (y f32 (B,S,H,dv), s_final f32 (B,H,dk,dv))."""
    chunk = check_contract(q, k, v, log_w, chunk)
    return _GLAScan.apply(q, k, v, log_w, chunk, exclusive)


gla_scan.launches = 0

"""Public wrappers for the port's kernels, the counterpart of
``repro/kernels/ops.py``.

There is no interpret mode and no switch: a wrapper runs its hand-written
kernel on CUDA tensors (or raises) and its plain PyTorch version on CPU
tensors only.  Kernels are built at first launch, never at import.
"""
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fp8_matmul import fp8_matmul, fp8_matmul_tile128
from repro_torch.kernels.relerr import (DEFAULT_BLOCK, packed_sq_norms,
                                       rel_err_fused)
from repro_torch.models.ssm import rwkv_bonus

__all__ = ["DEFAULT_BLOCK", "flash_attention", "fp8_matmul",
           "fp8_matmul_tile128", "gla_scan", "packed_sq_norms", "rel_err"]


def rel_err(a, b) -> float:
    """||a-b|| / ||a|| of one pair (||a-b|| where ||a|| = 0): one
    ``packed_sq_norms`` launch on CUDA tensors, its plain version on CPU
    tensors."""
    return rel_err_fused(a, b)


def gla_scan(q, k, v, log_w, chunk=128, exclusive=False, u=None):
    """Kernel-backed equivalent of ``models.ssm.lin_attn_chunked`` (s0 = 0):
    the scan, plus the rwkv6 current-token bonus when ``u`` is given, with
    y cast to v's dtype.  Launches are counted on
    ``kernels.ssm_scan.gla_scan.launches``."""
    y, s = _ssm.gla_scan(q, k, v, log_w, chunk=chunk, exclusive=exclusive)
    if u is not None:
        y = y + rwkv_bonus(q, k, v, u)
    return y.to(v.dtype), s

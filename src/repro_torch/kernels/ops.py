"""Public wrappers for the port's kernels, the counterpart of
``repro/kernels/ops.py``.

There is no interpret mode and no switch: a wrapper runs its hand-written
kernel on CUDA tensors (or raises) and its plain PyTorch version on CPU
tensors only.  Kernels are built at first launch, never at import.
"""
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fp8_matmul import fp8_matmul, fp8_matmul_tile128
from repro_torch.kernels.relerr import DEFAULT_BLOCK, packed_sq_norms

__all__ = ["DEFAULT_BLOCK", "flash_attention", "fp8_matmul",
           "fp8_matmul_tile128", "packed_sq_norms"]

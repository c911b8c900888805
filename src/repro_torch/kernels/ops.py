"""Public wrappers for the port's kernels, the counterpart of
``repro/kernels/ops.py``.

There is no interpret mode and no switch: a wrapper runs its hand-written
kernel on CUDA tensors (or raises) and its plain PyTorch version on CPU
tensors only.  Kernels are built at first launch, never at import.
"""
from repro_torch.kernels.relerr import DEFAULT_BLOCK, packed_sq_norms

__all__ = ["DEFAULT_BLOCK", "packed_sq_norms"]

"""PyTorch/CUDA port of the TTrace reference package (``repro``).

Each module mirrors the JAX module of the same subpackage and name.  The
port imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``.  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on; raises when a CUDA
    device is asked for and none is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:        # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

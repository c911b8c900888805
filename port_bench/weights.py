"""The benchmark's weights and batches, drawn on the device from the seed.

``make`` draws every leaf of a family's ``param_specs`` from one
``torch.randn`` over their total size (``mean + std * z``, then cast to
the leaf's dtype), so one seed gives the same values to the program and,
drawn again, to the reference.  ``batch`` draws a check's tokens
uniformly over the vocabulary from the seed and the check's index.
"""
from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1


def _seed(seed: int, index: int) -> int:
    return (seed * 6364136223846793005 + index * 1442695040888963407
            + 1) & _MASK


def make(specs, seed: int, device) -> dict:
    total = sum(math.prod(shape) for _, shape, *_ in specs)
    gen = torch.Generator(device=device).manual_seed(seed & _MASK)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, dtype, mean, std in specs:
        n = math.prod(shape)
        out[name] = (z[off:off + n].view(shape) * std + mean).to(dtype)
        off += n
    return out


def batch(vocab: int, B: int, S: int, seed: int, index: int, device) -> dict:
    """Check ``index``'s batch: ``tokens`` and their next tokens,
    ``labels``, both (B, S)."""
    gen = torch.Generator(device=device).manual_seed(_seed(seed, index))
    toks = torch.randint(0, vocab, (B, S + 1), generator=gen, device=device)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}

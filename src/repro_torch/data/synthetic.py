"""Deterministic synthetic token batches: the torch-native counterpart of
``repro/data/synthetic.py``.

The same Zipf-ish recipe (rank ~ u^(-1/(alpha-1)), then a random
permutation of the vocabulary), drawn from a ``torch.Generator`` seeded
from (seed, step).  The bits differ from the reference's ``jax.random``
ones; parity tests hand the reference's batch across instead.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


def _tokens(gen, batch, seq, vocab):
    """Zipf-ish token stream: rank ~ exp(u * log(V))."""
    u = torch.rand((batch, seq), generator=gen) * (1.0 - 1e-6) + 1e-6
    alpha = 1.1
    ranks = torch.clamp(torch.pow(u, -1.0 / (alpha - 1.0)), max=vocab)
    toks = torch.clamp(ranks.long() - 1, 0, vocab - 1)
    perm = torch.randperm(vocab, generator=gen)
    return perm[toks]


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
               step: int = 0, device="cuda") -> dict:
    """One global batch of ``tokens`` and next-token ``labels`` (int64)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    toks = _tokens(gen, batch, seq + 1, cfg.vocab).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

"""Deterministic synthetic batches: the torch-native counterpart of
``repro/data/synthetic.py``.

The same Zipf-ish token recipe (rank ~ u^(-1/(alpha-1)), then a random
permutation of the vocabulary), and the same stubbed frontends: Gaussian
frame features with a Bernoulli(0.08) mask and uniform targets for an
audio arch, Gaussian patch features ahead of the text for a VLM.  All are
drawn from a ``torch.Generator`` seeded from (seed, step).  The bits differ
from the reference's ``jax.random`` ones; parity tests hand the
reference's batch across instead.
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


def _to(dev: torch.device, t: torch.Tensor) -> torch.Tensor:
    if dev.type == "cuda":
        # pinned and non-blocking: a training loop never waits for the copy
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def make_batch(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
               step: int = 0, device="cuda") -> dict:
    """One global batch: ``tokens`` and next-token ``labels`` (int64); for
    an audio arch, f32 ``features`` (B, S, audio_dim), a bool ``mask`` and
    ``labels``; for a VLM, f32 ``image_embeds`` (B, n_img, vision_dim)
    with ``n_img = min(n_image_tokens, max(S - 16, 1))``, then S - n_img
    text ``tokens`` and ``labels``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
    if cfg.arch_type == "audio":
        feats = torch.randn((batch, seq, cfg.audio_dim), generator=gen)
        mask = torch.rand((batch, seq), generator=gen) < 0.08
        targets = torch.randint(0, cfg.vocab, (batch, seq), generator=gen)
        return {"features": _to(dev, feats), "mask": _to(dev, mask),
                "labels": _to(dev, targets)}
    out = {}
    if cfg.arch_type == "vlm":
        n_img = min(cfg.n_image_tokens, max(seq - 16, 1))
        out["image_embeds"] = _to(dev, torch.randn(
            (batch, n_img, cfg.vision_dim), generator=gen))
        seq -= n_img
    toks = _to(dev, _tokens(gen, batch, seq + 1, cfg.vocab))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], **out}


def make_decode_inputs(cfg: ArchConfig, batch: int, *, seed: int = 0,
                       step: int = 0, device="cuda") -> dict:
    """One decode step's ``tokens`` (B, 1), uniform over the vocabulary."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed((1000 + seed) * 1_000_003 + step)
    toks = torch.randint(0, cfg.vocab, (batch, 1), generator=gen)
    return {"tokens": toks.to(dev)}


class DataLoader:
    """Iterator facade over the stateless generator (launcher-facing).
    ``shape`` has ``global_batch`` and ``seq_len``."""

    def __init__(self, cfg: ArchConfig, shape, seed: int = 0,
                 device="cuda"):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self):
        b = make_batch(self.cfg, self.shape.global_batch, self.shape.seq_len,
                       seed=self.seed, step=self.step, device=self.device)
        self.step += 1
        return b

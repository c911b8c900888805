"""Serving step functions: the prefill and decode part of
``repro/launch/steps.py``.  ``input_specs`` and the training step wait for
the launchers' slice."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model):
    """``prefill_step(batch)``: the last position's logits (B, 1, vocab),
    the serving prefill contract, so the (B, S, vocab) logits never
    materialize."""
    @torch.no_grad()
    def prefill_step(batch):
        h = model.forward(batch)
        return model.unembed(h[:, -1:])
    return prefill_step


def make_serve_step(model: Model):
    """``serve_step(cache, batch)`` -> (logits, cache): one decode step of
    ``batch["tokens"]`` (B, 1) at ``batch["pos"]``."""
    def serve_step(cache, batch):
        return model.decode_step(cache, batch["tokens"], batch["pos"])
    return serve_step

"""Reference building blocks: the port of ``repro/models/layers.py``.

Linear weights keep the reference's ``(d_in, d_out)`` layout and compute
``x @ w``, so parameters cross packages without transposes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.tap import ensure_ctx


def dense_init(gen: torch.Generator, d_in, d_out, dtype, scale=None):
    scale = 0.02 if scale is None else scale
    return (scale * torch.randn(d_in, d_out, generator=gen)).to(dtype)


def rmsnorm(w, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def linear(w, x):
    return x @ w.to(x.dtype)


class Linear(nn.Module):
    """``{"w": (d_in, d_out)}``, as ``layers.linear_init`` without bias."""

    def __init__(self, gen, d_in, d_out, dtype, scale=None):
        super().__init__()
        self.w = nn.Parameter(dense_init(gen, d_in, d_out, dtype, scale))

    def forward(self, x):
        return linear(self.w, x)


class SwiGLUMLP(nn.Module):
    """``swiglu_mlp_init`` / ``swiglu_mlp``, tapping ``input`` and ``output``."""

    def __init__(self, gen, d_model, d_ff, dtype, out_scale=None):
        super().__init__()
        self.gate = Linear(gen, d_model, d_ff, dtype)
        self.up = Linear(gen, d_model, d_ff, dtype)
        self.down = Linear(gen, d_ff, d_model, dtype, scale=out_scale)

    def forward(self, x, ctx=None):
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        h = F.silu(self.gate(x)) * self.up(x)
        return ctx.tap("output", self.down(h))


def rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta), device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, d/2)
    if x.ndim == angles.ndim + 1:                          # broadcast over H
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE.  logits: (B,S,V) any float; labels: (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _logits(h, embed, scale=None):
    logits = h @ embed.T.to(h.dtype)
    if scale is not None:
        logits = logits * scale
    return logits

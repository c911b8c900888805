"""Reference building blocks: the port of ``repro/models/layers.py``.

Linear weights keep the reference's ``(d_in, d_out)`` layout and compute
``x @ w``, so parameters cross packages without transposes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    """``{"w": (d_in, d_out)}`` and, with ``bias``, ``"b": (d_out,)`` of
    zeros, as ``layers.linear_init``.  The bias is added in x's dtype after
    the product, as the reference's ``linear`` does (not fused into it)."""

    def __init__(self, gen, d_in, d_out, dtype, bias=False, scale=None):
        super().__init__()
        self.w = nn.Parameter(dense_init(gen, d_in, d_out, dtype, scale))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype)) if bias
                  else None)

    def add_bias(self, y):
        return y if self.b is None else y + self.b.to(y.dtype)

    def forward(self, x):
        return self.add_bias(linear(self.w, x))


def _mlp_linear(precision):
    """The matmul the MLPs use, ``lin(Linear, x)``: plain, or FP8-quantized
    per the recipe of ``precision`` (a ``precision.fp8.Precision``), the
    bias added after either."""
    if precision is None or not precision.fp8_recipe:
        return lambda m, x: m(x)
    from repro_torch.precision.fp8 import fp8_linear

    def lin(m, x):
        return m.add_bias(fp8_linear(m.w, x, recipe=precision.fp8_recipe,
                                     stale_scale=precision.stale_scale))

    return lin


class SwiGLUMLP(nn.Module):
    """``swiglu_mlp_init`` / ``swiglu_mlp``, tapping ``input`` and ``output``."""

    def __init__(self, gen, d_model, d_ff, dtype, out_scale=None):
        super().__init__()
        self.gate = Linear(gen, d_model, d_ff, dtype)
        self.up = Linear(gen, d_model, d_ff, dtype)
        self.down = Linear(gen, d_ff, d_model, dtype, scale=out_scale)

    def forward(self, x, ctx=None, precision=None):
        ctx = ensure_ctx(ctx)
        lin = _mlp_linear(precision)
        x = ctx.tap("input", x)
        h = F.silu(lin(self.gate, x)) * lin(self.up, x)
        return ctx.tap("output", lin(self.down, h))


class GeluMLP(nn.Module):
    """``gelu_mlp_init`` / ``gelu_mlp``: ``fc1`` and ``fc2`` with biases and
    the tanh GELU (``jax.nn.gelu``'s default), tapping ``input`` and
    ``output``."""

    def __init__(self, gen, d_model, d_ff, dtype, out_scale=None):
        super().__init__()
        self.fc1 = Linear(gen, d_model, d_ff, dtype, bias=True)
        self.fc2 = Linear(gen, d_ff, d_model, dtype, bias=True,
                          scale=out_scale)

    def forward(self, x, ctx=None, precision=None):
        ctx = ensure_ctx(ctx)
        lin = _mlp_linear(precision)
        x = ctx.tap("input", x)
        h = F.gelu(lin(self.fc1, x), approximate="tanh")
        return ctx.tap("output", lin(self.fc2, h))


def rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))


@functools.lru_cache(maxsize=32)
def _rope_table(d: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once: a copy per call would wait for the device
    return torch.as_tensor(rope_freqs(d, theta), device=device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    freqs = _rope_table(x.shape[-1], theta, x.device)
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


def _ce_chunk(hs, ls, ms, embed, scale):
    """Masked NLL sum and mask count of one chunk of sequence positions."""
    logits = _logits(hs, embed, scale).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    return torch.sum((lse - gold) * ms), torch.sum(ms)


def chunked_cross_entropy(h, embed, labels, mask=None, chunk=512,
                          scale=None):
    """CE computed from hidden states without materializing (B,S,V) logits.

    ``h``: (B,S,D) final hidden states; ``embed``: (V,D) output embedding.
    Loops over sequence chunks, each recomputed in the backward, so peak
    memory is O(B*chunk*V).  Falls back to ``cross_entropy`` when S is not
    a multiple of ``chunk``.
    """
    B, S, D = h.shape
    if S % chunk != 0:
        return cross_entropy(_logits(h, embed, scale), labels, mask)
    n = S // chunk
    hc = h.reshape(B, n, chunk, D).transpose(0, 1)           # (n,B,c,D)
    lc = labels.reshape(B, n, chunk).transpose(0, 1)         # (n,B,c)
    mc = (mask.reshape(B, n, chunk).transpose(0, 1).float()
          if mask is not None
          else torch.ones((n, B, chunk), dtype=torch.float32, device=h.device))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n):
        nll, c = checkpoint(_ce_chunk, hc[i], lc[i], mc[i], embed, scale,
                            use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + nll, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def _logits(h, embed, scale=None):
    logits = h @ embed.T.to(h.dtype)
    if scale is not None:
        logits = logits * scale
    return logits

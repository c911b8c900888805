"""Model assembly: the dense-decoder port of ``repro/models/model.py``.

``named_parameters()`` gives exactly the reference's
``collector.flatten_named(params)`` names (``embedding.word_embeddings``,
``final_norm``, ``layers.{i}.self_attention.linear_qkv.w``, ...), and the
forward taps the reference's names in the reference's order.  Sharding
constraints have no counterpart on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.attention import GQAttention
from repro_torch.models.layers import (SwiGLUMLP, _logits, cross_entropy,
                                       rmsnorm)

# the reference switches to chunked_cross_entropy above S * V = 2^26
_CHUNKED_CE_ELEMS = 1 << 26


@dataclass(frozen=True)
class Segment:
    name: str          # params key; also the tap scope
    kind: str          # attn_mlp (the only kind ported so far)
    n: int             # number of layers in this segment
    layer0: int        # global index of the first layer (canonical naming)


def build_plan(cfg: ArchConfig) -> list[Segment]:
    if cfg.arch_type != "dense" or cfg.attn not in ("full", "swa"):
        # MoE / SSM / hybrid / MLA and the frontends are later slices
        raise NotImplementedError(
            f"{cfg.name}: only dense GQA decoders are ported so far")
    return [Segment("layers", "attn_mlp", cfg.n_layers, 0)] if cfg.n_layers else []


def _out_scale(cfg):  # megatron-style scaled residual-output init
    return 0.02 / math.sqrt(2.0 * max(cfg.n_layers, 1))


class Block(nn.Module):
    """``block_init`` / ``block_apply`` for the ``attn_mlp`` kind."""

    def __init__(self, gen, cfg: ArchConfig, dtype):
        super().__init__()
        osc = _out_scale(cfg)
        self.input_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.post_attn_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        self.self_attention = GQAttention(gen, cfg, dtype, osc)
        self.mlp = SwiGLUMLP(gen, cfg.d_model, cfg.d_ff, dtype, osc)

    def forward(self, x, ctx):
        h = rmsnorm(self.input_norm, x)
        with ctx.scope("self_attention"):
            x = x + self.self_attention(h, ctx=ctx)
        h = rmsnorm(self.post_attn_norm, x)
        with ctx.scope("mlp"):
            x = x + self.mlp(h, ctx=ctx)
        return x


class Embedding(nn.Module):
    def __init__(self, gen, vocab, d_model, dtype):
        super().__init__()
        self.word_embeddings = nn.Parameter(
            (0.02 * torch.randn(vocab, d_model, generator=gen)).to(dtype))


class Model(nn.Module):
    """Parameters are drawn from a ``torch.Generator`` seeded with ``seed``
    (on the CPU, so one seed gives one model on every device) and live on
    ``device``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.plan = build_plan(cfg)
        dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        self.embedding = Embedding(gen, cfg.vocab, cfg.d_model, dtype)
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                (0.02 * torch.randn(cfg.vocab, cfg.d_model, generator=gen)
                 ).to(dtype))
        self.layers = nn.ModuleList(Block(gen, cfg, dtype)
                                    for seg in self.plan for _ in range(seg.n))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def embed(self, batch, ctx=None):
        ctx = ensure_ctx(ctx)
        with ctx.scope("embedding"):
            h = F.embedding(batch["tokens"], self.embedding.word_embeddings)
            h = ctx.tap("output", h.to(self.cdtype))
        return h

    def apply_blocks(self, h, ctx=None):
        ctx = ensure_ctx(ctx)
        for seg in self.plan:
            for j in range(seg.n):
                li = seg.layer0 + j
                with ctx.scope(f"layers.{li}"):
                    h = self.layers[li](h, ctx)
        h = rmsnorm(self.final_norm, h)
        return ctx.tap("final_norm_out", h)

    def forward(self, batch, ctx=None):
        return self.apply_blocks(self.embed(batch, ctx), ctx)

    def loss(self, batch, ctx=None):
        cfg = self.cfg
        h = self.forward(batch, ctx)
        e = (self.embedding.word_embeddings if cfg.tie_embeddings
             else self.lm_head)
        if h.shape[1] * cfg.vocab > _CHUNKED_CE_ELEMS:
            raise NotImplementedError(
                "chunked_cross_entropy (S * vocab > 2^26) is not ported yet")
        ce = cross_entropy(_logits(h, e), batch["labels"],
                           mask=batch.get("loss_mask"))
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux": aux}

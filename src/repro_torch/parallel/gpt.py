"""Distributed GPT/Llama candidate model (manual collectives): the dense
part of ``repro/parallel/gpt.py``.

Mirrors the reference ``models.model.Model`` tap-for-tap: the same
canonical module names, the same block structure — but built from the
manual-parallel layers so TP/SP/CP silent bugs have somewhere to live.
Runs on rank-stacked tensors over an emulated ``parallel.mesh.Mesh``.
Expert parallelism (``tp_moe``) arrives with the MoE models.
"""
from __future__ import annotations

import torch

from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import rmsnorm
from repro_torch.parallel.layers import (
    AX_CP, AX_TP, axis_size, g_copy, local_positions, rank_matmul, sp_gather,
    tp_gqa_attention, tp_swiglu_mlp, vocab_parallel_ce,
    vocab_parallel_embedding,
)


def tp_moe(mesh, p_local, cfg, x, sp: bool, bugs=frozenset(), ctx=None):
    raise NotImplementedError(
        "expert-parallel MoE blocks are not ported yet (ROADMAP A9)")


def _norm(mesh, w, x):
    return rmsnorm(mesh.rank_view(w, x.ndim), x)


def parallel_block(mesh, p, cfg, x, q_pos, li: int, sp: bool, moe: bool,
                   bugs, ctx):
    ctx = ensure_ctx(ctx)
    with ctx.scope(f"layers.{li}"):
        h = _norm(mesh, p["input_norm"], x)
        with ctx.scope("self_attention"):
            a = tp_gqa_attention(mesh, p["self_attention"], cfg, h, q_pos, sp,
                                 bugs=bugs, ctx=ctx)
        x = x + a
        h = _norm(mesh, p["post_attn_norm"], x)
        stats = None
        with ctx.scope("mlp"):
            if moe:
                mo, stats = tp_moe(mesh, p["mlp"], cfg, h, sp, bugs=bugs,
                                   ctx=ctx)
            else:
                mo = tp_swiglu_mlp(mesh, p["mlp"], h, sp, bugs=bugs, ctx=ctx)
        x = x + mo
    return x, stats


def parallel_gpt_loss(mesh, params, batch, cfg, sp: bool, bugs=frozenset(),
                      ctx=None):
    """Returns ``(grad_loss, report_loss)``, each ``(ranks,)``: a dense
    model has no auxiliary loss, so both are every rank's local mean CE.
    ``batch`` tokens/labels are rank-stacked ``(ranks, B_local, S_local)``
    zigzag-layout shards."""
    ctx = ensure_ctx(ctx)
    tokens, labels = batch["tokens"], batch["labels"]
    cp = axis_size(mesh, AX_CP)
    S_global = tokens.shape[2] * cp
    q_pos = local_positions(mesh, S_global)

    with ctx.scope("embedding"):
        h = vocab_parallel_embedding(
            mesh, params["embedding"]["word_embeddings"], tokens, cfg.vocab,
            bugs=bugs, reduce="scatter" if sp else "psum")
        h = h.to(getattr(torch, cfg.compute_dtype))
        h = ctx.tap("output", h)

    moe = cfg.arch_type == "moe"
    for li, p in enumerate(params["layers"]):
        h, _ = parallel_block(mesh, p, cfg, h, q_pos, li, sp, moe, bugs, ctx)

    h = _norm(mesh, params["final_norm"], h)
    h = ctx.tap("final_norm_out", h)
    if sp:
        h = sp_gather(mesh, h)
    elif axis_size(mesh, AX_TP) > 1:
        h = g_copy(mesh, h)
    e = (params["embedding"]["word_embeddings"] if cfg.tie_embeddings
         else params["lm_head"])
    logits_local = rank_matmul(h, e.transpose(1, 2).to(h.dtype))
    nll = vocab_parallel_ce(mesh, logits_local, labels, cfg.vocab)
    ce = nll.mean(dim=tuple(range(1, nll.ndim)))
    return ce, ce

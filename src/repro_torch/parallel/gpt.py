"""Distributed GPT/Llama/MoE candidate model (manual collectives): the
port of ``repro/parallel/gpt.py``.

Mirrors the reference ``models.model.Model`` tap-for-tap: the same
canonical module names, the same block structure — but built from the
manual-parallel layers so TP/SP/CP/EP silent bugs have somewhere to live.
Runs on rank-stacked tensors over an emulated ``parallel.mesh.Mesh``.

Supports the paper's evaluation families: dense GPT/Llama blocks and MoE
blocks (top-k router + expert parallelism over the tp axis).
"""
from __future__ import annotations

import torch

from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import (dispatch_combine, expert_capacity,
                                    expert_counts, load_balance_loss,
                                    router_topk)
from repro_torch.parallel.layers import (
    AX_CP, AX_DP, AX_TP, axis_index, axis_size, g_copy, g_reduce,
    g_reduce_over, local_positions, rank_matmul, sp_gather,
    tp_gqa_attention, tp_swiglu_mlp, vocab_parallel_ce,
    vocab_parallel_embedding,
)


# ---------------------------------------------------------------------------
# Expert-parallel MoE (experts sharded over the tp axis)
# ---------------------------------------------------------------------------

def tp_moe(mesh, p_local, cfg, x, sp: bool, bugs=frozenset(), ctx=None):
    """Router replicated; experts sharded over tp.  Each rank routes ALL
    (local-sequence) tokens, processes the ones assigned to its local
    experts, and the outputs are summed over tp.

    ``moe_router_not_synced`` (paper bug 6): the router weights differ per
    rank (missed broadcast at init) so ranks disagree about routing."""
    ctx = ensure_ctx(ctx)
    x = ctx.tap("input", x)
    if sp:
        x = sp_gather(mesh, x)
    elif axis_size(mesh, AX_TP) > 1:
        x = g_copy(mesh, x)
    m = cfg.moe
    tp = axis_size(mesh, AX_TP)
    El = m.n_experts // tp
    R, B, S, d = x.shape
    T = B * S
    xt = x.reshape(R, T, d)

    router = p_local["router"]
    if "moe_router_not_synced" in bugs:
        # per-rank drift: the weights each rank *thinks* are synced
        r = axis_index(mesh, AX_TP).float()
        router = router * (1.0 + 0.05 * r)[:, None, None]
    logits = rank_matmul(xt.float(), router)
    logits = ctx.tap("router_logits",
                     logits.reshape(R, B, S, -1)).reshape(R, T, -1)
    top_p, top_e = router_topk(logits, m.top_k)

    yt = dispatch_combine(xt, top_p, top_e, p_local["experts"],
                          m.n_experts, expert_capacity(T, m),
                          e0=axis_index(mesh, AX_TP) * El)
    y = yt.reshape(R, B, S, d).to(x.dtype)            # local-expert partials
    if sp:
        y = mesh.psum_scatter(y, AX_TP, dim=1)
    else:
        y = g_reduce(mesh, y)                         # combine expert shards
    y = ctx.tap("output", y)
    # Load-balance statistics.  Divided by tp so that, like the dispatch
    # path, each rank holds a PARTIAL contribution: the caller reduces over
    # (dp, cp, tp) with a conjugate psum, which makes both the router-grad
    # all-reduce and the router_logits probe-gradient psum exact.
    probs = torch.softmax(logits, dim=-1)
    stats = {"probs_sum": probs.sum(1) / tp,
             "count": expert_counts(top_e, m.n_experts) / tp,
             "n_tokens": torch.full((R, 1), T / tp, device=x.device)}
    return y, stats


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
    """Returns ``(grad_loss, report_loss)``, each ``(ranks,)``:
    ``grad_loss`` follows the explicit dp/cp gradient-averaging convention
    (aux pre-multiplied by dp*cp); ``report_loss`` is every rank's true
    local loss (ce_mean + aux).  ``batch`` tokens/labels are rank-stacked
    ``(ranks, B_local, S_local)`` zigzag-layout shards."""
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

    moe = cfg.moe is not None
    all_stats = []
    for li, p in enumerate(params["layers"]):
        h, stats = parallel_block(mesh, p, cfg, h, q_pos, li, sp, moe, bugs,
                                  ctx)
        if stats is not None:
            all_stats.append(stats)

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

    # router load-balance aux loss from GLOBAL statistics: stats are summed
    # across dp/cp with a conjugate reduce so each rank's backward receives
    # its own piece of the global gradient.  The (dp*cp) factor compensates
    # the caller's explicit psum/(dp*cp) gradient averaging.
    if all_stats:
        axes = (AX_DP, AX_CP, AX_TP)
        dpcp = axis_size(mesh, AX_DP) * axis_size(mesh, AX_CP)
        m = cfg.moe
        aux = torch.zeros_like(ce)
        for st in all_stats:
            ps = g_reduce_over(mesh, st["probs_sum"], axes)
            cn = g_reduce_over(mesh, st["count"], axes)
            n_g = g_reduce_over(mesh, st["n_tokens"], axes)
            aux = aux + load_balance_loss(ps / n_g, cn / (n_g * m.top_k),
                                          m.n_experts) * m.router_aux_coef
        return ce + aux * dpcp, ce + aux
    return ce, ce

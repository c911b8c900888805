"""Distributed GPT/Llama/MoE candidate model (manual collectives): the
port of ``repro/parallel/gpt.py``.

Mirrors the reference ``models.model.Model`` tap-for-tap: the same
canonical module names, the same block structure — but built from the
manual-parallel layers so TP/SP/CP/EP silent bugs have somewhere to live.
Runs on rank-stacked tensors over an emulated ``parallel.mesh.Mesh``.

Supports the paper's evaluation families: dense GPT/Llama blocks and MoE
blocks (top-k router + expert parallelism over the tp axis), and
DeepSeek-V3's: MLA attention (``tp_mla_attention``), leading dense layers
(the plain model's ``dense_layers``, SwiGLU of ``d_ff_dense``), shared
experts, the sigmoid bias-corrected router with its sequence-wise balance
loss, and a layer holding a share of the experts, split over tp.
"""
from __future__ import annotations

import torch

from repro_torch.core import spans
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import (dispatch_combine, expert_capacity,
                                    expert_counts, held_counts,
                                    load_balance_loss, route)
from repro_torch.parallel.layers import (
    AX_CP, AX_DP, AX_TP, axis_index, axis_size, g_copy, g_reduce,
    g_reduce_over, local_positions, rank_matmul, sp_gather,
    tp_gqa_attention, tp_mla_attention, tp_swiglu_mlp, vocab_parallel_ce,
    vocab_parallel_embedding,
)


# ---------------------------------------------------------------------------
# Expert-parallel MoE (experts sharded over the tp axis)
# ---------------------------------------------------------------------------

def router_bias(p_local):
    """Every rank's score-correction bias, ``(ranks, 1, E)``, or None."""
    b = p_local.get("score_correction", {}).get("b")
    return None if b is None else b[:, None, :]


def tp_moe(mesh, p_local, cfg, x, sp: bool, bugs=frozenset(), ctx=None):
    """Router replicated; experts sharded over tp.  Each rank routes ALL
    (local-sequence) tokens, processes the ones assigned to its local
    experts, and the outputs are summed over tp.  The layer's held
    experts (``n_held`` from ``held_offset``) split over tp: rank ``r``
    holds ``n_held / tp`` from ``held_offset + r * n_held / tp``.  Shared
    experts run as a tp-parallel MLP beside them.

    ``moe_router_not_synced`` (paper bug 6): the router weights differ per
    rank (missed broadcast at init) so ranks disagree about routing."""
    ctx = ensure_ctx(ctx)
    with spans.span("moe") as span:
        x_in = span.grad_end(ctx.tap("input", x))
        y, stats = _tp_moe(mesh, p_local, cfg, x_in, sp, bugs, ctx)
        return span.grad_start(y), stats


def _tp_moe(mesh, p_local, cfg, x_in, sp, bugs, ctx):
    if sp:
        x = sp_gather(mesh, x_in)
    elif axis_size(mesh, AX_TP) > 1:
        x = g_copy(mesh, x_in)
    else:
        x = x_in
    m = cfg.moe
    tp = axis_size(mesh, AX_TP)
    El = m.held // tp
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
    top_p, top_e, probs = route(logits, m, router_bias(p_local))

    cap = expert_capacity(T, m)
    e0 = m.held_offset + axis_index(mesh, AX_TP) * El
    if spans.active() is not None:
        rows, dropped = held_counts(top_e, m.n_experts, cap, e0, El)
        spans.count_device("rows_held", rows)
        spans.count_device("dropped", dropped)
    yt = dispatch_combine(xt, top_p, top_e, p_local["experts"],
                          m.n_experts, cap, e0=e0)
    y = yt.reshape(R, B, S, d).to(x.dtype)            # local-expert partials
    if sp:
        y = mesh.psum_scatter(y, AX_TP, dim=1)
    else:
        y = g_reduce(mesh, y)                         # combine expert shards
    if m.n_shared:
        # a tp SwiGLU over the layer's (local) input, reduced over tp; no
        # taps of its own, as in the plain layer
        y = y + tp_swiglu_mlp(mesh, p_local["shared"], x_in, sp)
    y = ctx.tap("output", y)
    # Load-balance statistics.  Divided by tp so that, like the dispatch
    # path, each rank holds a PARTIAL contribution: the caller reduces over
    # (dp, cp, tp) with a conjugate psum (over (cp, tp), per sequence, for
    # the sequence-wise loss), which makes both the router-grad all-reduce
    # and the router_logits probe-gradient psum exact.
    if m.scoring == "sigmoid":
        top_e = top_e.reshape(R, B, S, -1)
        stats = {"probs_sum": probs.reshape(R, B, S, -1).sum(2) / tp,
                 "count": expert_counts(top_e, m.n_experts) / tp,
                 "n_tokens": torch.full((R, B, 1), S / tp, device=x.device)}
    else:
        stats = {"probs_sum": probs.sum(1) / tp,
                 "count": expert_counts(top_e, m.n_experts) / tp,
                 "n_tokens": torch.full((R, 1), T / tp, device=x.device)}
    return y, stats


def _norm(mesh, w, x):
    return rmsnorm(mesh.rank_view(w, x.ndim), x)


def parallel_block(mesh, p, cfg, x, q_pos, li: int, sp: bool, moe: bool,
                   bugs, ctx):
    """Layer ``li``: GQA or (``attn == "mla"``) MLA attention, then the
    expert-parallel MoE (``moe``) or a dense SwiGLU MLP."""
    ctx = ensure_ctx(ctx)
    attend = tp_mla_attention if cfg.attn == "mla" else tp_gqa_attention
    with ctx.scope(f"layers.{li}"):
        h = _norm(mesh, p["input_norm"], x)
        with ctx.scope("self_attention"):
            a = attend(mesh, p["self_attention"], cfg, h, q_pos, sp,
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


def _blocks(params, cfg):
    """``(layer index, params, is MoE)`` of every layer in order: an MoE
    arch's leading ``dense_layers``, then ``layers``."""
    dense = params.get("dense_layers", {})
    dense = [dense[str(i)] for i in range(len(dense))]
    moe = cfg.moe is not None
    return ([(i, p, False) for i, p in enumerate(dense)]
            + [(len(dense) + j, p, moe)
               for j, p in enumerate(params["layers"])])


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

    all_stats = []
    for li, p, moe in _blocks(params, cfg):
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
    # The sequence-wise loss reduces its statistics over (cp, tp) only: a
    # sequence lies on one dp rank, whose loss is the mean over its own
    # sequences, so the caller's averaging over dp is the mean over the
    # batch and only the cp factor is compensated.
    if all_stats:
        m = cfg.moe
        per_seq = m.scoring == "sigmoid"
        axes = (AX_CP, AX_TP) if per_seq else (AX_DP, AX_CP, AX_TP)
        scale = axis_size(mesh, AX_CP) * (
            1 if per_seq else axis_size(mesh, AX_DP))
        aux = torch.zeros_like(ce)
        for st in all_stats:
            ps = g_reduce_over(mesh, st["probs_sum"], axes)
            cn = g_reduce_over(mesh, st["count"], axes)
            n_g = g_reduce_over(mesh, st["n_tokens"], axes)
            lb = load_balance_loss(ps / n_g, cn / (n_g * m.top_k),
                                   m.n_experts)
            if per_seq:
                lb = lb.mean(-1)
            aux = aux + lb * m.router_aux_coef
        return ce + aux * scale, ce + aux
    return ce, ce

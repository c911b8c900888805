"""Manual tensor/sequence/context-parallel layers: the port of
``repro/parallel/layers.py``.

These are the Megatron-style hand-written distributed layers — explicit
``psum`` / ``all_gather`` / ``psum_scatter`` collectives on a
("dp", "cp", "tp") mesh — i.e. the *candidate* side of TTrace's
differential test.  Every function takes ``bugs`` (a frozenset of ids from
``bugs.registry``) and injects the corresponding silent bug when asked:
this file is where Table 1's bug taxonomy lives.

Every function takes the emulated ``parallel.mesh.Mesh`` first; tensors
are rank-stacked (dim 0 = ranks), and "local" means a rank's shard, so a
local ``(B, S, d)`` activation is a ``(ranks, B, S, d)`` tensor here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.attention import NEG_INF, attention
from repro_torch.models.layers import apply_rope, rmsnorm

AX_DP, AX_CP, AX_TP = "dp", "cp", "tp"


def axis_size(mesh, name) -> int:
    return mesh.axis_size(name)


def axis_index(mesh, name) -> torch.Tensor:
    return mesh.axis_index(name)


# ---------------------------------------------------------------------------
# Megatron's conjugate communication operators (f / g).
#
# Under shard_map with unchecked replication a bare psum transposes to a
# psum, so AD through it double-counts.  The classic fix — exactly what
# Megatron's ``copy_to_tensor_model_parallel_region`` and
# ``reduce_from_tensor_model_parallel_region`` do — is a conjugate pair:
#   g_copy:   identity forward, psum backward   (enter column-parallel compute)
#   g_reduce: psum forward, identity backward   (leave row-parallel compute)
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._psum(g, ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def g_copy(mesh, x):
    if mesh.axis_size(AX_TP) == 1:
        return x
    return _Copy.apply(x, mesh, (AX_TP,))


def g_reduce(mesh, x):
    if mesh.axis_size(AX_TP) == 1:
        return x
    return _Reduce.apply(x, mesh, (AX_TP,))


def g_reduce_over(mesh, x, axes):
    """psum-forward / identity-backward over arbitrary axes (the conjugate
    reduce for cross-rank statistics like the MoE load-balance stats)."""
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
    if not axes:
        return x
    return _Reduce.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# Zigzag context-parallel layout helpers (paper Fig 6: striped attention)
# ---------------------------------------------------------------------------

def zigzag_order(cp: int) -> list[int]:
    """Chunk order such that contiguous rank splits give zigzag stripes:
    rank r owns chunks (r, 2cp-1-r)."""
    out = []
    for r in range(cp):
        out += [r, 2 * cp - 1 - r]
    return out


def permute_to_zigzag(x, cp: int, dim: int):
    if cp == 1:
        return x
    chunks = torch.chunk(x, 2 * cp, dim=dim)
    return torch.cat([chunks[c] for c in zigzag_order(cp)], dim=dim)


def permute_from_zigzag(x, cp: int, dim: int):
    if cp == 1:
        return x
    order = zigzag_order(cp)
    inv = [order.index(i) for i in range(2 * cp)]
    chunks = torch.chunk(x, 2 * cp, dim=dim)
    return torch.cat([chunks[c] for c in inv], dim=dim)


def local_positions(mesh, seq_global: int):
    """Absolute token positions of every rank's zigzag stripes:
    ``(ranks, S_local)`` int64."""
    cp = axis_size(mesh, AX_CP)
    dev = mesh.device
    if cp == 1:
        return torch.arange(seq_global, device=dev).expand(mesh.n_ranks, -1)
    r = axis_index(mesh, AX_CP)[:, None]
    chunk = seq_global // (2 * cp)
    ar = torch.arange(chunk, device=dev)
    a = r * chunk + ar
    b = (2 * cp - 1 - r) * chunk + ar
    return torch.cat([a, b], dim=1)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding (bug 1 lives here)
# ---------------------------------------------------------------------------

def vocab_parallel_embedding(mesh, w_local, tokens, vocab: int,
                             bugs=frozenset(), reduce: str = "psum"):
    """w_local: (V/tp, d) — this rank's vocab rows.  Wrong ownership mask
    (``tp_wrong_embedding_mask``) lets boundary tokens be embedded by two
    ranks and double-counted by the all-reduce — paper bug 1.

    ``reduce``: "psum" (full output) or "scatter" (sequence-parallel:
    reduce-scatter along seq, output (B, S/tp, d))."""
    tp = axis_size(mesh, AX_TP)
    per = vocab // tp
    start = mesh.rank_view(axis_index(mesh, AX_TP), tokens.ndim) * per
    if "tp_wrong_embedding_mask" in bugs:
        # wrong upper bound: this rank also claims the next rank's lower
        # half; those tokens hit the clipped last row AND get double-counted
        # by the all-reduce (paper bug 1: wrong forward + gradients)
        own = (tokens >= start) & (tokens < start + per + per // 2)
    else:
        own = (tokens >= start) & (tokens < start + per)
    local_idx = torch.clamp(tokens - start, 0, per - 1)
    # each rank reads its own table: offset its rows into the stacked one
    base = mesh.rank_view(torch.arange(w_local.shape[0], device=tokens.device),
                          tokens.ndim) * per
    emb = F.embedding(local_idx + base, w_local.reshape(-1, w_local.shape[-1]))
    emb = torch.where(own[..., None], emb, 0.0)
    if reduce == "scatter":
        return mesh.psum_scatter(emb, AX_TP, dim=1)
    return g_reduce(mesh, emb)


# ---------------------------------------------------------------------------
# Column / row parallel linears
# ---------------------------------------------------------------------------

def rank_matmul(x, w):
    """Each rank's ``x @ w``: x (ranks, ..., i), w (ranks, i, o)."""
    y = torch.matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def _add_bias(mesh, y, p_local):
    if "b" in p_local:
        y = y + mesh.rank_view(p_local["b"], y.ndim).to(y.dtype)
    return y


def column_linear(mesh, p_local, x):
    """weights sharded on the OUTPUT dim; no forward comm."""
    y = rank_matmul(x, p_local["w"].to(x.dtype))
    return _add_bias(mesh, y, p_local)


def one_rank(mesh, x, axis):
    """Model a missing/wrong collective silently: in the real framework every
    rank keeps its own (conflicting) partial value — the paper's "conflicting
    tensor".  Our single-trace runner takes rank 0's partial so the result is
    one consistent, silently-wrong value."""
    return mesh.first(x, axis)


def row_linear(mesh, p_local, x_local, bugs=frozenset(), reduce_out=True,
               bug_axis_id="tp_wrong_allreduce_axis",
               bug_missing_id="tp_missing_row_psum"):
    """weights sharded on the INPUT dim; output needs a psum over tp.

    Bugs: wrong all-reduce group (psum over dp — paper bug 7 analogue) or a
    missing all-reduce (partial sums downstream — paper bugs 6/11 class)."""
    y = rank_matmul(x_local, p_local["w"].to(x_local.dtype))
    if reduce_out:
        if bug_missing_id in bugs:
            y = one_rank(mesh, y, AX_TP)          # M-CM: forgot the psum
        elif bug_axis_id in bugs:
            y = mesh.psum(y, AX_DP)               # W-CM: wrong group
            y = one_rank(mesh, y, AX_TP)
        else:
            y = g_reduce(mesh, y)
    return _add_bias(mesh, y, p_local)


# ---------------------------------------------------------------------------
# Sequence parallelism (gather/scatter along seq over the tp axis)
# ---------------------------------------------------------------------------

def sp_gather(mesh, x, dim=1):
    return mesh.all_gather(x, AX_TP, dim=dim)


def sp_scatter(mesh, x, dim=1):
    return mesh.psum_scatter(x, AX_TP, dim=dim)


# ---------------------------------------------------------------------------
# Context-parallel attention (zigzag stripes; KV all-gather)
# ---------------------------------------------------------------------------

def _cp_attention_math(q, k, v, q_pos, k_pos):
    R, B, Q, H, D = q.shape
    Hkv = k.shape[3]
    G = H // Hkv
    qg = q.reshape(R, B, Q, Hkv, G, D)
    s = torch.einsum("rbqhgd,rbkhd->rbhgqk", qg.float(),
                     k.float()) / math.sqrt(D)
    mask = k_pos[:, None, :] <= q_pos[:, :, None]              # (R, Q, K)
    s = s.masked_fill(~mask[:, None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rbhgqk,rbkhd->rbqhgd", p, v.float())
    return o.reshape(R, B, Q, H, D).to(q.dtype)


class _WrongGradAttention(torch.autograd.Function):
    """Correct forward; the backward is that of the attention at
    ``bad_q_pos`` (``cp_wrong_attention_grad``)."""

    @staticmethod
    def forward(ctx, q, kg, vg, q_pos, k_pos, bad_q_pos):
        ctx.save_for_backward(q, kg, vg, k_pos, bad_q_pos)
        return _cp_attention_math(q, kg, vg, q_pos, k_pos)

    @staticmethod
    def backward(ctx, g):
        q, kg, vg, k_pos, bad_q_pos = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (q, kg, vg)]
            out = _cp_attention_math(*args, bad_q_pos, k_pos)
            grads = torch.autograd.grad(out, args, g)
        return (*grads, None, None, None)


def cp_attention(mesh, q, k, v, q_pos, bugs=frozenset()):
    """q,k,v local zigzag stripes (B, S/cp, H_local, D); gathers K/V over cp.

    ``cp_wrong_attention_grad`` (paper bug 13): forward is correct but the
    backward uses the FIRST stripe's positions for both stripes, dropping the
    second stripe's causal-mask correction."""
    cp = axis_size(mesh, AX_CP)
    if cp == 1:
        return _cp_attention_math(q, k, v, q_pos, q_pos)
    kg = mesh.all_gather(k, AX_CP, dim=1)
    vg = mesh.all_gather(v, AX_CP, dim=1)
    k_pos = mesh.all_gather(q_pos, AX_CP, dim=0)

    if "cp_wrong_attention_grad" not in bugs:
        return _cp_attention_math(q, kg, vg, q_pos, k_pos)

    half = q_pos.shape[1] // 2
    bad_q_pos = torch.cat([q_pos[:, :half], q_pos[:, :half]], dim=1)
    return _WrongGradAttention.apply(q, kg, vg, q_pos, k_pos, bad_q_pos)


# ---------------------------------------------------------------------------
# TP attention block (heads sharded over tp)
# ---------------------------------------------------------------------------

def tp_gqa_attention(mesh, p_local, cfg, x, q_pos, sp: bool,
                     bugs=frozenset(), ctx=None):
    """x: (B, S_local, d_model) — seq local under SP/CP, else full.
    Head-parallel attention with fused column-parallel linear_qkv (its
    bias, if any, split with its columns) and row-parallel linear_proj.
    ``q_norm`` / ``k_norm`` are replicated and normalize the local heads;
    their gradients are summed over tp (``api._needs_tp_reduce``)."""
    ctx = ensure_ctx(ctx)
    x = ctx.tap("input", x)
    tp = axis_size(mesh, AX_TP)
    H, Hkv, D = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.d_head
    if sp:
        x = sp_gather(mesh, x)    # attention region runs on the full sequence
    elif tp > 1:
        x = g_copy(mesh, x)       # enter column-parallel compute
    R, B, S, _ = x.shape
    qkv = column_linear(mesh, p_local["linear_qkv"], x)
    q, k, v = torch.split(qkv, [H * D, Hkv * D, Hkv * D], dim=-1)
    q = q.reshape(R, B, S, H, D)
    k = k.reshape(R, B, S, Hkv, D)
    v = v.reshape(R, B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm(mesh.rank_view(p_local["q_norm"], q.ndim), q)
        k = rmsnorm(mesh.rank_view(p_local["k_norm"], k.ndim), k)
    pos_b = q_pos[:, None, :].expand(R, B, S)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    o = cp_attention(mesh, q, k, v, q_pos, bugs=bugs)
    o = o.reshape(R, B, S, H * D)
    o = ctx.tap("core_attn_out", o)
    pp = p_local["linear_proj"]
    if sp:
        yl = _matmul(o, pp["w"], stale_wgrad="sp_stale_wgrad" in bugs)
        y = mesh.psum_scatter(yl, AX_TP, dim=1)
        y = _add_bias(mesh, y, pp)
    else:
        y = row_linear(mesh, pp, o, bugs=bugs,
                       bug_missing_id="attn_missing_row_psum")
    return ctx.tap("output", y)


def tp_mla_attention(mesh, p_local, cfg, x, q_pos, sp: bool,
                     bugs=frozenset(), ctx=None):
    """Multi-head latent attention with its heads over tp (no cp): the
    query's up-projection (``linear_q``, or ``linear_uq`` after the
    replicated ``linear_dq`` and ``q_lora_norm``), ``linear_uk`` and
    ``linear_uv`` column-parallel (each head's columns contiguous), the
    latent (``linear_dkv``, ``kv_lora_norm``) and the shared rope key
    (``linear_krope``) replicated, ``linear_proj`` row-parallel.  Each rank
    backprops only its heads into the replicated leaves, so their
    gradients are summed over tp (``api._needs_tp_reduce``).  The core is
    the plain model's ``attention`` over the rank's heads (blockwise above
    S 2048), each rank's batch one slice of its batch dimension.  Under a
    check its forward and backward are the span ``mla``."""
    ctx = ensure_ctx(ctx)
    if axis_size(mesh, AX_CP) > 1:
        raise ValueError("MLA attention has no context-parallel path")
    with spans.span("mla") as span:
        x = span.grad_end(ctx.tap("input", x))
        m, tp = cfg.mla, axis_size(mesh, AX_TP)
        H = cfg.n_heads // tp
        dq = m.qk_nope_dim + m.qk_rope_dim
        if sp:
            x = sp_gather(mesh, x)
        elif tp > 1:
            x = g_copy(mesh, x)
        R, B, S, _ = x.shape
        pos_b = q_pos[:, None, :].expand(R, B, S)
        if m.q_lora_rank:
            cq = column_linear(mesh, p_local["linear_dq"], x)
            cq = rmsnorm(mesh.rank_view(p_local["q_lora_norm"], cq.ndim), cq)
            q = column_linear(mesh, p_local["linear_uq"], cq)
        else:
            q = column_linear(mesh, p_local["linear_q"], x)
        q = q.reshape(R, B, S, H, dq)
        q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim],
                                     dim=-1)
        q_rope = apply_rope(q_rope, pos_b, cfg.rope_theta)
        ckv = column_linear(mesh, p_local["linear_dkv"], x)
        ckv = rmsnorm(mesh.rank_view(p_local["kv_lora_norm"], ckv.ndim), ckv)
        k_rope = apply_rope(column_linear(mesh, p_local["linear_krope"], x),
                            pos_b, cfg.rope_theta)
        k_nope = column_linear(mesh, p_local["linear_uk"], ckv).reshape(
            R, B, S, H, m.qk_nope_dim)
        v = column_linear(mesh, p_local["linear_uv"], ckv).reshape(
            R, B, S, H, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[..., None, :].expand(
            R, B, S, H, m.qk_rope_dim)], dim=-1)
        o = attention(q.reshape(R * B, S, H, dq), k.reshape(R * B, S, H, dq),
                      v.reshape(R * B, S, H, m.v_head_dim), mode="causal")
        o = ctx.tap("core_attn_out", o.reshape(R, B, S, H * m.v_head_dim))
        pp = p_local["linear_proj"]
        if sp:
            y = mesh.psum_scatter(rank_matmul(o, pp["w"].to(o.dtype)), AX_TP,
                                  dim=1)
            y = _add_bias(mesh, y, pp)
        else:
            y = row_linear(mesh, pp, o, bugs=bugs,
                           bug_missing_id="attn_missing_row_psum")
        return span.grad_start(ctx.tap("output", y))


class _StaleWgradMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, w):
        ctx.save_for_backward(o, w)
        return rank_matmul(o, w.to(o.dtype))

    @staticmethod
    def backward(ctx, g):
        o, w = ctx.saved_tensors
        do = rank_matmul(g, w.to(g.dtype).transpose(1, 2))
        S = o.shape[2]
        o_stale = torch.cat([o[:, :, :S // 2],
                             torch.zeros_like(o[:, :, S // 2:])], dim=2)
        dw = torch.einsum("rbsi,rbso->rio", o_stale.float(),
                          g.float()).to(w.dtype)
        return do, dw


def _matmul(o, w, stale_wgrad=False):
    """o @ w; with ``stale_wgrad`` (paper bug 11 — wrong gradients with
    comm/compute overlap) the forward and dgrad are correct but dW is
    computed from a half-zeroed activation, as if the overlapped backward
    all-gather returned a stale buffer."""
    if not stale_wgrad:
        return rank_matmul(o, w.to(o.dtype))
    return _StaleWgradMatmul.apply(o, w)


# ---------------------------------------------------------------------------
# TP MLP (column gate/up, row down)
# ---------------------------------------------------------------------------

def tp_swiglu_mlp(mesh, p_local, x, sp: bool, bugs=frozenset(), ctx=None):
    ctx = ensure_ctx(ctx)
    x = ctx.tap("input", x)
    if sp:
        x = sp_gather(mesh, x)
    elif axis_size(mesh, AX_TP) > 1:
        x = g_copy(mesh, x)
    h = (F.silu(column_linear(mesh, p_local["gate"], x))
         * column_linear(mesh, p_local["up"], x))
    y = _maybe_stale_recompute(h, bugs)
    if sp:
        yl = rank_matmul(y, p_local["down"]["w"].to(y.dtype))
        out = mesh.psum_scatter(yl, AX_TP, dim=1)
    else:
        out = row_linear(mesh, p_local["down"], y, bugs=bugs,
                         bug_axis_id="mlp_wrong_allreduce_axis")
    return ctx.tap("output", out)


class _StaleRecompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return torch.roll(g, 1, dims=2)   # grad routed to shifted positions


def _maybe_stale_recompute(h, bugs):
    """``ar_stale_recompute`` (paper bug 2): activation recomputation uses an
    outdated input — forward is right, the backward sees a token-shifted h."""
    if "ar_stale_recompute" not in bugs:
        return h
    return _StaleRecompute.apply(h)


# ---------------------------------------------------------------------------
# Vocab-parallel cross entropy
# ---------------------------------------------------------------------------

def vocab_parallel_ce(mesh, logits_local, labels, vocab: int):
    """logits_local: (B, S_local, V/tp).  Max/sumexp/gold psum'ed over tp.
    Returns per-token nll (B, S_local)."""
    tp = axis_size(mesh, AX_TP)
    per = vocab // tp
    start = mesh.rank_view(axis_index(mesh, AX_TP), labels.ndim) * per
    lf = logits_local.float()
    # max is a constant shift for stability — detach it (pmax has no AD rule;
    # the gradient is exact anyway since the shift cancels in lse - gold)
    m = mesh.pmax(torch.amax(lf.detach(), dim=-1), AX_TP)
    se = g_reduce(mesh, torch.sum(torch.exp(lf - m[..., None]), dim=-1))
    lse = torch.log(se) + m
    own = (labels >= start) & (labels < start + per)
    lidx = torch.clamp(labels - start, 0, per - 1)
    gold_local = torch.gather(lf, -1, lidx[..., None])[..., 0]
    gold = g_reduce(mesh, torch.where(own, gold_local, 0.0))
    return lse - gold

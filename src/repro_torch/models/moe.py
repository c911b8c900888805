"""Mixture-of-Experts: top-k router + capacity-based expert dispatch; the
port of ``repro/models/moe.py``.

Dispatch uses the reference's sort-based capacity layout: token-expert
assignments are sorted by expert id (stably, so an expert's tokens keep
their order), each expert processes a fixed-capacity ``(E, C, d)`` buffer
through one batched matmul, and overflow assignments are dropped
(``capacity_factor`` sets C).  As in the reference, the tokens are split
into ``G = sharding/rules.dispatch_groups(T, E)`` groups, each routed with
its own capacity: one group without a sharding context, one a data shard
under ``rules.activate`` when the experts divide the model axis.  Per-group
capacities drop other tokens than one global capacity, so G changes
values; the aux loss stays global.  The port's entry points run one
device's program, whose tokens are one data shard: one group.

Every (expert, slot) of the buffer holds at most one assignment, and every
kept assignment sits in exactly one slot, so the dispatch and the combine
are two partial permutations of rows.  Both run as gathers (``_Route``),
and so do their backward passes, which gather through the inverse map: no
scatter, no atomic add, and a token's k contributions are summed over a
fixed axis.  Two runs on the card are bit-identical.

Router logits are tapped (paper bug 6, router weights not synchronized,
surfaces exactly there).

The port-only ``scoring="sigmoid"`` (``configs/base.PORT_MOE_FIELDS``)
gives DeepSeek-V3's router: f32 sigmoid scores over all experts, the top
k of scores plus a score-correction bias (the bias selects and never
weighs, so its gradient is zero), the chosen scores renormalized and
scaled (``routed_scaling_factor``); and its sequence-wise balance loss
(arXiv:2412.19437 eqs. 17-20): per sequence ``f_i = E / (k S) * #{t : i chosen at t}`` and ``P_i =
mean_t s_it / sum_j s_jt``, ``coef * sum_i f_i P_i`` meaned over the
sequences.  A layer may hold ``n_held`` of the experts from
``held_offset``: it routes over all of them and computes its own
(capacity is the whole layer's, ``expert_capacity``), the part one
expert-parallel group of a larger deployment holds.

Under a check (``core/spans``) the layer's forward and backward are the
span ``moe``, and ``moe.rows_held`` / ``moe.dropped`` count on the device
the routed assignments landing on held experts and those dropped there
for capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import spans
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import SwiGLUMLP, dense_init
from repro_torch.sharding import rules


def router_topk(logits, top_k):
    """fp32 softmax-then-topk with renormalization.  logits: (..., E).
    A stable descending sort: on exact ties the lower expert comes first,
    as ``jax.lax.top_k`` orders them."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return top_p, top_e


def router_scores(logits, m):
    """f32 scores over the experts: softmax, or DeepSeek-V3's sigmoid."""
    if m.scoring == "sigmoid":
        return torch.sigmoid(logits.float())
    if m.scoring != "softmax":
        raise ValueError(f"unknown router scoring {m.scoring!r}")
    return torch.softmax(logits.float(), dim=-1)


def select_topk(scores, m, bias=None):
    """``(weights, experts)`` (..., k) from f32 ``scores`` (..., E): the k
    largest of ``scores + bias`` (a stable descending sort: ties to the
    lower expert), weighed by their own scores renormalized to sum to
    one, times ``m.routed_scaling_factor``."""
    key = scores if bias is None else scores + bias
    top_e = torch.sort(key, dim=-1, descending=True,
                       stable=True).indices[..., :m.top_k]
    top_p = torch.gather(scores, -1, top_e)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    if m.routed_scaling_factor != 1.0:
        top_p = top_p * m.routed_scaling_factor
    return top_p, top_e


def route(logits, m, bias=None):
    """``(weights, experts, probs)``: the router's choice and the per-token
    distribution the balance loss reads.  The reference's router
    (``router_topk``, ``probs`` its softmax) unless the config sets a
    port-only router field."""
    if m.scoring == "softmax" and m.routed_scaling_factor == 1.0:
        top_p, top_e = router_topk(logits, m.top_k)
        return top_p, top_e, torch.softmax(logits, dim=-1)
    scores = router_scores(logits, m)
    top_p, top_e = select_topk(scores, m, bias)
    probs = (scores if m.scoring == "softmax"
             else scores / scores.sum(-1, keepdim=True))
    return top_p, top_e, probs


def load_balance_loss(probs_mean, assigned_frac, n_experts):
    """Switch-style aux loss: E * sum_e f_e * P_e (over the last dim)."""
    return n_experts * torch.sum(probs_mean * assigned_frac, dim=-1)


def expert_counts(top_e, n_experts: int):
    """Assignments per expert of ``top_e`` ``(..., T, k)``: f32 ``(...,
    E)``, a compare-and-sum histogram (exact, and free of CUDA's scatter
    atomics)."""
    e = torch.arange(n_experts, device=top_e.device)
    return (top_e[..., None] == e).sum((-3, -2)).float()


def seq_balance_loss(probs, top_e, n_experts: int, top_k: int):
    """The sequence-wise balance loss without its coefficient: ``probs``
    (..., B, S, E) and ``top_e`` (..., B, S, k) give ``(...,)``, the mean
    over the B sequences of ``E * sum_i P_i * n_i / (S k)``."""
    S = top_e.shape[-2]
    counts = expert_counts(top_e, n_experts)              # (..., B, E)
    return load_balance_loss(probs.mean(-2), counts / (S * top_k),
                             n_experts).mean(-1)


def held_counts(top_e, n_experts: int, cap: int, e0, n_local: int):
    """``(rows, dropped)``, int64 device scalars: of ``top_e`` ``(R, T,
    k)``'s assignments, those whose expert is among routing ``r``'s
    ``n_local`` from ``e0[r]`` (or from ``e0``, an int, for all), and
    those of them past the ``cap`` an expert keeps."""
    counts = expert_counts(top_e, n_experts)              # (R, E)
    idx = (torch.as_tensor(e0, device=counts.device).reshape(-1, 1)
           + torch.arange(n_local, device=counts.device))
    held = torch.gather(counts, 1, idx.expand(counts.shape[0], -1))
    return (held.sum().long(),
            torch.clamp(held - cap, min=0).sum().long())


def expert_capacity(n_tokens: int, m) -> int:
    """Per-expert buffer size; capacity_factor <= 0 means dropless.
    Rounded up to a multiple of 512 above 512, as the reference."""
    if m.capacity_factor <= 0:
        return n_tokens
    cap = int(max(1, m.capacity_factor * n_tokens * m.top_k / m.n_experts))
    if cap > 512:
        cap = -(-cap // 512) * 512
    return cap


def dispatch_maps(top_e, n_experts: int, cap: int, e0=None, n_local=None):
    """Where every assignment goes, for ``R`` routings at once.

    ``top_e``: int ``(R, T, k)``; ``e0``: ``(R,)`` first expert each routing
    owns (``None``: all ``n_experts``, ``n_local`` of them from ``e0``).
    Assignment ``a = t * k + j`` of routing ``r`` is row ``r * T * k + a``;
    slot ``c`` of local expert ``e`` is buffer row ``(r * n_local + e) *
    cap + c``.  An assignment is kept when its expert is local and it is
    among the first ``cap`` of that expert's assignments in token order
    (the reference's ``pos < cap``).

    Returns ``(slot, src, dropped)``: ``slot`` ``(R*T*k,)`` the buffer row
    of each assignment, or the buffer's row count if not kept; ``src``
    ``(R*n_local*cap,)`` the assignment each buffer row holds, or
    ``R*T*k`` if empty; ``dropped`` ``(R,)`` the assignments each routing
    drops for capacity (over all experts)."""
    R, T, k = top_e.shape
    N = T * k
    n_local = n_experts if n_local is None else n_local
    dev = top_e.device
    flat_e = top_e.reshape(R, N)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=dev).expand(R, -1).contiguous()
    start = torch.searchsorted(se, experts, side="left")          # (R, E)
    count = torch.searchsorted(se, experts, side="right") - start
    pos = torch.arange(N, device=dev) - torch.gather(start, 1, se)
    e0 = (torch.zeros(R, dtype=torch.long, device=dev) if e0 is None
          else e0.to(device=dev, dtype=torch.long))
    le = se - e0[:, None]
    keep = (le >= 0) & (le < n_local) & (pos < cap)
    rows = R * n_local * cap
    slot_sorted = torch.where(
        keep, (torch.arange(R, device=dev)[:, None] * n_local + le) * cap
        + pos, rows)
    # the inverse of a permutation is its argsort: a gather, not a scatter
    slot = torch.gather(slot_sorted, 1, torch.argsort(order, dim=-1))
    local = e0[:, None] + torch.arange(n_local, device=dev)       # (R, El)
    first = torch.gather(start, 1, local)[..., None] + torch.arange(
        cap, device=dev)                                          # (R, El, C)
    held = (torch.arange(cap, device=dev)
            < torch.gather(count, 1, local)[..., None])
    asg = torch.gather(order, 1, first.clamp(max=N - 1).reshape(R, -1))
    src = torch.where(held.reshape(R, -1),
                      asg + torch.arange(R, device=dev)[:, None] * N, R * N)
    dropped = (pos >= cap).sum(-1)
    return slot.reshape(-1), src.reshape(-1), dropped


def _pick(x, idx):
    """Rows ``idx`` of ``x``; index ``len(x)`` picks a row of zeros."""
    pad = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return pad.index_select(0, idx)


class _Route(torch.autograd.Function):
    """``out[j] = x[idx[j]]`` for an ``idx`` that uses each row of ``x`` at
    most once; ``inv`` is its inverse (``inv[idx[j]] = j``, and ``len(out)``
    for a row no ``j`` picks).  The backward is the gather through ``inv``."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        return _pick(x, idx)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return _pick(g, inv), None, None


def dispatch_combine(xt, top_p, top_e, experts: dict, n_experts: int,
                     cap: int, e0=None):
    """Capacity dispatch + expert compute + combine for ``R`` routings:
    the reference's ``_dispatch_one_group`` (``e0 is None``) and the
    local-expert part of ``parallel/gpt.tp_moe`` (``e0`` each routing's
    first local expert).

    ``xt`` ``(R, T, d)`` in the compute dtype; ``top_p``/``top_e``
    ``(R, T, k)``; ``experts`` leaves ``(R, El, ...)``, one set a routing,
    or ``(El, ...)``, one set for every routing (the grouped dispatch:
    each expert's ``R * cap`` rows go through one matmul).  Returns the
    f32 ``(R, T, d)`` sum of each token's kept, weighted expert
    outputs."""
    R, T, d = xt.shape
    k = top_e.shape[-1]
    shared = experts["gate"].dim() == 3
    El = experts["gate"].shape[-3]
    f = experts["gate"].shape[-1]
    slot, src, _ = dispatch_maps(top_e, n_experts, cap, e0=e0, n_local=El)
    xa = xt[:, :, None, :].expand(R, T, k, d).reshape(R * T * k, d)
    buf = _Route.apply(xa, src, slot)
    dt = xt.dtype
    if shared:
        # (R, El, C, d) -> (El, R * C, d); a view at R == 1
        buf = buf.reshape(R, El, cap, d).transpose(0, 1).reshape(
            El, R * cap, d)
        gate, up, down = (experts[n].to(dt) for n in ("gate", "up", "down"))
    else:
        buf = buf.reshape(R * El, cap, d)
        gate = experts["gate"].to(dt).reshape(R * El, d, f)
        up = experts["up"].to(dt).reshape(R * El, d, f)
        down = experts["down"].to(dt).reshape(R * El, f, d)
    h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    out = torch.bmm(h, down)
    if shared:
        out = out.reshape(El, R, cap, d).transpose(0, 1)
    out = out.reshape(R * El * cap, d)
    ya = _Route.apply(out, slot, src).reshape(R, T, k, d)
    return (ya.float() * top_p[..., None]).sum(2)


def moe_forward(p: dict, cfg, x, ctx=None):
    """x: (B,S,d).  Returns (y, aux_loss).  ``p``: ``{"router": (d, E) f32,
    "experts": {"gate", "up", "down"}}`` (the held ``(n_held, ...)``
    experts; ``"bias"``, the (E,) f32 score-correction bias, with the
    sigmoid router; ``"shared"``, a ``SwiGLUMLP``, with shared
    experts)."""
    with spans.span("moe") as sp:
        return _moe_forward(p, cfg, x, ensure_ctx(ctx), sp)


def _moe_forward(p, cfg, x, ctx, sp):
    x = sp.grad_end(ctx.tap("input", x))
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]                            # (T,E) fp32
    logits = ctx.tap("router_logits",
                     logits.reshape(B, S, -1)).reshape(T, -1)
    top_p, top_e, probs = route(logits, m, p.get("bias"))

    if m.scoring == "sigmoid":
        aux = seq_balance_loss(probs.reshape(B, S, -1),
                               top_e.reshape(B, S, -1), m.n_experts,
                               m.top_k) * m.router_aux_coef
    else:
        # aux loss statistics (global)
        aux = load_balance_loss(
            probs.mean(0), expert_counts(top_e, m.n_experts) / (T * m.top_k),
            m.n_experts) * m.router_aux_coef

    # grouped capacity dispatch: G routings of T / G tokens each
    G = rules.dispatch_groups(T, m.n_experts)
    Tg = T // G
    cap = expert_capacity(Tg, m)
    top_e = top_e.reshape(G, Tg, m.top_k)
    if spans.active() is not None:
        rows, dropped = held_counts(top_e, m.n_experts, cap, m.held_offset,
                                    m.held)
        spans.count_device("rows_held", rows)
        spans.count_device("dropped", dropped)
    yt = dispatch_combine(xt.reshape(G, Tg, d),
                          top_p.reshape(G, Tg, m.top_k), top_e,
                          p["experts"], m.n_experts, cap, e0=(
                              torch.full((G,), m.held_offset, device=x.device)
                              if m.held_offset else None))
    y = yt.reshape(B, S, d).to(x.dtype)
    if m.n_shared:
        y = y + p["shared"](x)
    y = ctx.tap("output", y)
    return sp.grad_start(y), aux


class Experts(nn.Module):
    """The stacked expert weights: ``gate``/``up`` (E, d, f), ``down``
    (E, f, d)."""

    def __init__(self, gen, n_experts, d, f, dtype, out_scale=None):
        super().__init__()

        def normal(scale, *shape):
            return nn.Parameter(
                (scale * torch.randn(*shape, generator=gen)).to(dtype))

        self.gate = normal(0.02, n_experts, d, f)
        self.up = normal(0.02, n_experts, d, f)
        self.down = normal(out_scale or 0.02, n_experts, f, d)


class ScoreCorrection(nn.Module):
    """DeepSeek-V3's score-correction bias, ``b`` (E,) f32 of zeros: it
    moves the router's choice and never its weights, so it takes no
    gradient (and, named ``b``, no weight decay)."""

    def __init__(self, n_experts):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(n_experts, dtype=torch.float32))


class MoE(nn.Module):
    """``moe_init`` / ``moe_forward``: an f32 router, the stacked experts
    and, with ``n_shared``, an always-on shared SwiGLU MLP.  Parameter
    names are the reference's (``router``, ``experts.{gate,up,down}``,
    ``shared.{gate,up,down}.w``); with the sigmoid router, the port-only
    ``score_correction.b``.  The experts are the ``n_held`` the layer
    holds."""

    def __init__(self, gen, cfg, dtype, out_scale=None):
        super().__init__()
        m = cfg.moe
        self.cfg = cfg
        d, f = cfg.d_model, m.d_ff_expert
        self.router = nn.Parameter(dense_init(gen, d, m.n_experts,
                                              torch.float32))
        if m.scoring == "sigmoid":
            self.score_correction = ScoreCorrection(m.n_experts)
        self.experts = Experts(gen, m.held, d, f, dtype, out_scale)
        if m.n_shared:
            self.shared = SwiGLUMLP(gen, d, m.n_shared * f, dtype,
                                    out_scale=out_scale)

    def forward(self, x, ctx=None):
        p = {"router": self.router,
             "experts": {n: getattr(self.experts, n)
                         for n in ("gate", "up", "down")}}
        if self.cfg.moe.scoring == "sigmoid":
            p["bias"] = self.score_correction.b
        if self.cfg.moe.n_shared:
            p["shared"] = self.shared
        return moe_forward(p, self.cfg, x, ctx=ctx)

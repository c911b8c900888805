"""SSM / linear-attention blocks: the port of ``repro/models/ssm.py``,
Mamba2 (SSD) and RWKV-6 "Finch".

Both SSM families are instances of a gated linear-attention
recurrence over a per-head state S in R^{dk x dv}:

    S_t = diag(w_t) . S_{t-1} + k_t v_t^T
    y_t = q_t . S_t                             (mamba2 convention), or
    y_t = q_t . (S_{t-1} + diag(u) k_t v_t^T)   (rwkv6 convention)

* ``lin_attn_recurrent`` — step by step; the numerical oracle;
* ``lin_attn_chunked``   — the chunked parallel form, the training path and
  the contract of the ``gla_scan`` kernel (``kernels/ssm_scan``).  The
  scalar decay (mamba2) uses the exact relative-decay matrix; the
  per-channel decay (rwkv6) the "safe gate" factorization
  (q*exp(L)) @ (k*exp(-L))^T with L clamped at -CLAMP.

``chunk_scan`` is that chunked math on its own (no bonus, no cast), shared
with the kernel's plain version.  The intra-chunk products of every chunk
are taken at once; only the (dk, dv) state walks the chunks in a loop.
``Mamba2`` is ``mamba2_init`` / ``mamba2_forward``: q and k are its C and
B projections broadcast over the heads (views of head stride 0, as the
reference's ``broadcast_to``), the decay a scalar per head.
``mamba2_init_state`` and ``rwkv6_init_state`` give the decode states the
mixers continue from (``state=``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import Linear, dense_init, linear, rmsnorm

CLAMP = 20.0


def _compute_dtype(*xs) -> torch.dtype:
    """f32, or float64 when an input is float64 (gradcheck, oracles)."""
    ct = torch.float32
    for x in xs:
        ct = torch.promote_types(ct, x.dtype)
    return ct


# ---------------------------------------------------------------------------
# Generic decayed linear attention
# ---------------------------------------------------------------------------

def lin_attn_recurrent(q, k, v, log_w, u=None, s0=None):
    """q,k:(B,S,H,dk) v:(B,S,H,dv) log_w:(B,S,H,dk|1) (log decay, <=0).

    Returns y:(B,S,H,dv) in v's dtype, s_final:(B,H,dk,dv).  ``u``:(H,dk)
    switches to the rwkv convention (bonus on the current token, decay
    applied after the read)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    ct = _compute_dtype(q, k, v, log_w)
    s = (torch.zeros((B, H, dk, dv), dtype=ct, device=q.device)
         if s0 is None else s0.to(ct))
    ys = []
    for t in range(S):
        qt, kt, vt = q[:, t].to(ct), k[:, t].to(ct), v[:, t].to(ct)
        wt = torch.exp(log_w[:, t].to(ct))[..., None]           # (B,H,dk,1)
        kv = kt[..., None] * vt[..., None, :]
        if u is None:
            s = wt * s + kv
            y = torch.einsum("bhk,bhkv->bhv", qt, s)
        else:
            y = torch.einsum("bhk,bhkv->bhv", qt,
                             s + u.to(ct)[None, :, :, None] * kv)
            s = wt * s + kv
        ys.append(y)
    return torch.stack(ys, dim=1).to(v.dtype), s


def prefix_sum(x, dim):
    """Inclusive prefix sum along ``dim`` in log2(n) shifted adds
    (Hillis-Steele).  PyTorch refuses ``torch.cumsum`` on CUDA under
    ``use_deterministic_algorithms``; this order of sums is fixed on every
    device."""
    n = x.shape[dim]
    step = 1
    while step < n:
        head = torch.zeros_like(x.narrow(dim, 0, step))
        x = x + torch.cat([head, x.narrow(dim, 0, n - step)], dim=dim)
        step *= 2
    return x


def chunk_scan(q, k, v, log_w, chunk, exclusive=False, s0=None):
    """The chunked scan of ``lin_attn_chunked`` with S % chunk == 0.

    ``exclusive`` reads S_{t-1} (rwkv6) instead of S_t.  Computes in f32
    (float64 for float64 inputs).  Returns y (B,S,H,dv) and the final
    state (B,H,dk,dv) in that dtype."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    C = chunk
    n = S // C
    ct = _compute_dtype(q, k, v, log_w)

    def split(x):  # (B,S,H,*) -> (B,H,n,C,*)
        return x.reshape(B, n, C, H, x.shape[-1]).permute(0, 3, 1, 2, 4).to(ct)

    qc, kc, vc, lw = split(q), split(k), split(v), split(log_w)
    L = prefix_sum(lw, dim=3)                         # inclusive log-decay
    Lq = L - lw if exclusive else L                   # rwkv reads S_{t-1}
    q_t = qc * torch.exp(Lq)
    if log_w.shape[-1] == 1:
        # exact relative decay exp(Lq_t - L_s), scalar per head
        D = torch.exp(torch.clamp(Lq[..., 0][..., :, None]
                                  - L[..., 0][..., None, :], max=0.0))
        A = torch.einsum("bhntk,bhnsk->bhnts", qc, kc) * D
    else:
        k_t = kc * torch.exp(-torch.clamp(L, min=-CLAMP))
        A = torch.einsum("bhntk,bhnsk->bhnts", q_t, k_t)
    causal = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device),
                        -1 if exclusive else 0)
    A = torch.where(causal, A, torch.zeros((), dtype=ct, device=q.device))
    y = torch.einsum("bhnts,bhnsv->bhntv", A, vc)      # intra-chunk

    # state update: S' = exp(L_C) . S + sum_s exp(L_C - L_s) k_s v_s^T
    Lc = L[..., -1:, :]                                # (B,H,n,1,dk)
    kv = torch.einsum("bhnsk,bhnsv->bhnkv", kc * torch.exp(Lc - L), vc)
    decay = torch.exp(Lc[..., 0, :])[..., None]        # (B,H,n,dk|1,1)
    s = (torch.zeros((B, H, dk, dv), dtype=ct, device=q.device)
         if s0 is None else s0.to(ct))
    starts = []
    for c in range(n):
        starts.append(s)
        s = decay[:, :, c] * s + kv[:, :, c]
    y = y + torch.einsum("bhntk,bhnkv->bhntv", q_t,
                         torch.stack(starts, dim=2))   # inter-chunk
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, dv), s


def rwkv_bonus(q, k, v, u):
    """The rwkv6 current-token term, (q . u . k) v, in f32: (B,S,H,dv)."""
    ct = _compute_dtype(q, k, v, u)
    bonus = torch.sum(q.to(ct) * u.to(ct) * k.to(ct), dim=-1)   # (B,S,H)
    return bonus[..., None] * v.to(ct)


def lin_attn_chunked(q, k, v, log_w, chunk=128, u=None, s0=None):
    """Chunked parallel form; same contract as ``lin_attn_recurrent``.

    ``log_w`` may be (B,S,H,dk) (per-channel decay, rwkv6) or (B,S,H,1)
    (scalar per-head decay, mamba2).  The scalar case is exact; the
    per-channel case is exact whenever the per-chunk cumulative decay stays
    above -CLAMP.  Falls back to the recurrence when S % chunk != 0."""
    S = q.shape[1]
    if S % chunk != 0:
        return lin_attn_recurrent(q, k, v, log_w, u=u, s0=s0)
    y, s = chunk_scan(q, k, v, log_w, chunk, exclusive=u is not None, s0=s0)
    # the rwkv current-token bonus is added outside the scan
    if u is not None:
        y = y + rwkv_bonus(q, k, v, u)
    return y.to(v.dtype), s


def lin_attn(q, k, v, log_w, chunk=128, u=None, s0=None, chunked=True):
    if chunked:
        return lin_attn_chunked(q, k, v, log_w, chunk=chunk, u=u, s0=s0)
    return lin_attn_recurrent(q, k, v, log_w, u=u, s0=s0)


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.d_head
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def _causal_conv(w, b, x, state=None):
    """Depthwise causal conv1d as the reference's explicit sum of K shifted
    products in x's dtype.  x:(B,S,C), w:(K,C).  ``state``:(B,K-1,C) are
    the trailing inputs of the previous segment (decode)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return y + b.to(x.dtype), new_state


class Mamba2(nn.Module):
    """``mamba2_init`` / ``mamba2_forward``: the in-projection to z, x, B, C
    and dt, a depthwise causal conv per segment (x, B, C), the scan through
    the module-level ``lin_attn`` (scalar per-head decay, inclusive), the
    D skip, a gated RMS norm over all of d_inner and the out-projection."""

    def __init__(self, gen, cfg: ArchConfig, dtype, out_scale=None):
        super().__init__()
        s = cfg.ssm
        d_inner, H, conv_dim = mamba2_dims(cfg)
        f32 = torch.float32
        self.cfg = cfg
        # z, x, B, C, dt
        self.in_proj = Linear(gen, cfg.d_model,
                              2 * d_inner + 2 * s.d_state + H, dtype)
        self.conv_w = nn.Parameter(dense_init(gen, s.conv_kernel, conv_dim,
                                              dtype, scale=0.2))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype))
        self.A_log = nn.Parameter(torch.zeros(H, dtype=f32))   # A = -1
        self.D = nn.Parameter(torch.ones(H, dtype=f32))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=f32))
        self.gate_norm = nn.Parameter(torch.ones(d_inner, dtype=dtype))
        self.out_proj = Linear(gen, d_inner, cfg.d_model, dtype,
                               scale=out_scale)

    def forward(self, x, ctx=None, state=None, chunked=True):
        """x:(B,S,d_model); ``state``: dict(conv, ssm) to continue from
        (decode).  Returns (y, new state)."""
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        s = self.cfg.ssm
        d_inner, H, _ = mamba2_dims(self.cfg)
        B, S, _ = x.shape
        z, xin, Bm, Cm, dt = torch.split(
            self.in_proj(x), [d_inner, d_inner, s.d_state, s.d_state, H],
            dim=-1)
        # the conv runs per segment, as the reference's (same sums)
        conv_state = None if state is None else state["conv"]
        outs, new_states = [], []
        off = 0
        for seg in (xin, Bm, Cm):
            w = seg.shape[-1]
            st = None if conv_state is None else conv_state[..., off:off + w]
            o, ns = _causal_conv(self.conv_w[:, off:off + w],
                                 self.conv_b[off:off + w], seg, st)
            outs.append(F.silu(o))
            new_states.append(ns)
            off += w
        xin, Bm, Cm = outs
        new_conv = (None if new_states[0] is None
                    else torch.cat(new_states, dim=-1))

        dt = F.softplus(dt.float() + self.dt_bias)                  # (B,S,H)
        log_w = (dt * -torch.exp(self.A_log))[..., None]            # (B,S,H,1)
        xh = xin.reshape(B, S, H, s.d_head)
        v = xh.float() * dt[..., None]                              # dt * x
        q = Cm[:, :, None, :].expand(B, S, H, s.d_state)
        k = Bm[:, :, None, :].expand(B, S, H, s.d_state)

        ssm_state = None if state is None else state["ssm"]
        y, new_ssm = lin_attn(q, k, v.to(x.dtype), log_w, chunk=s.chunk,
                              s0=ssm_state, chunked=chunked)
        y = y.float() + self.D[None, None, :, None] * xh.float()
        y = y.reshape(B, S, d_inner).to(x.dtype)
        y = rmsnorm(self.gate_norm, y * F.silu(z))
        out = ctx.tap("output", self.out_proj(y))
        return out, {"conv": new_conv, "ssm": new_ssm}


def mamba2_init_state(cfg: ArchConfig, batch, dtype, device):
    """Zero decode state of one Mamba2 mixer: the conv's trailing inputs
    (B, K-1, conv_dim) in ``dtype`` and the scan state (B,H,d_state,d_head)
    in f32."""
    s = cfg.ssm
    _, H, conv_dim = mamba2_dims(cfg)
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, s.d_state, s.d_head),
                               dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------

def _token_shift(x, last):
    """last:(B,1,d) trailing token of the previous segment (or zeros)."""
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _shift_of(x, state):
    B, _, d = x.shape
    if state is None:
        return torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    return state["shift"]


class RWKV6TimeMix(nn.Module):
    """``rwkv6_init``'s ``time_mix`` / ``rwkv6_time_mix``: data-dependent
    token shift and decay (Finch), the scan through the module-level
    ``lin_attn``, a per-head group norm and the output gate."""

    def __init__(self, gen, cfg: ArchConfig, dtype, out_scale=None):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        H, dh = cfg.n_heads, cfg.ssm.d_head
        f32 = torch.float32
        self.cfg = cfg
        self.mu_x = nn.Parameter(0.5 * torch.ones(d, dtype=f32))
        # data-dependent token-shift mixing: 5 targets r, k, v, w, g
        self.mix_A = nn.Parameter(dense_init(gen, d, 5 * s.mix_lora, dtype))
        self.mix_B = nn.Parameter((0.02 * torch.randn(
            5, s.mix_lora, d, generator=gen)).to(dtype))
        self.mu = nn.Parameter(0.5 * torch.ones(5, d, dtype=f32))
        self.recept = Linear(gen, d, H * dh, dtype)
        self.key = Linear(gen, d, H * dh, dtype)
        self.value = Linear(gen, d, H * dh, dtype)
        self.gate = Linear(gen, d, H * dh, dtype)
        # data-dependent decay: w = exp(-exp(w0 + lora(x)))
        self.w0 = nn.Parameter(-6.0 + torch.zeros(H * dh, dtype=f32))
        self.decay_A = nn.Parameter(dense_init(gen, d, s.decay_lora, dtype))
        self.decay_B = nn.Parameter(dense_init(gen, s.decay_lora, H * dh,
                                               dtype))
        self.u = nn.Parameter(0.5 * torch.ones(H, dh, dtype=f32))  # bonus
        self.ln_out = nn.Parameter(torch.ones(H * dh, dtype=dtype))
        self.out = Linear(gen, H * dh, d, dtype, scale=out_scale)

    def forward(self, x, ctx=None, state=None, chunked=True):
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        s = self.cfg.ssm
        H, dh = self.cfg.n_heads, s.d_head
        B, S, d = x.shape
        xx = _token_shift(x, _shift_of(x, state)) - x
        xxx = x + xx * self.mu_x.to(x.dtype)
        dmix = torch.tanh(linear(self.mix_A, xxx)).reshape(B, S, 5, s.mix_lora)
        dmix = torch.einsum("bsfm,fmd->bsfd", dmix.float(), self.mix_B.float())
        mixes = self.mu[None, None] + dmix                       # (B,S,5,d)
        xr, xk, xv, xw, xg = [x + xx * mixes[:, :, i].to(x.dtype)
                              for i in range(5)]

        r = self.recept(xr).reshape(B, S, H, dh)
        k = self.key(xk).reshape(B, S, H, dh)
        v = self.value(xv).reshape(B, S, H, dh)
        g = self.gate(xg)
        dlora = torch.tanh(linear(self.decay_A, xw))
        dw = linear(self.decay_B, dlora).float()
        log_w = -torch.exp(self.w0[None, None] + dw)            # <= 0
        log_w = log_w.reshape(B, S, H, dh)

        ssm_state = None if state is None else state["ssm"]
        y, new_ssm = lin_attn(r, k, v, log_w, chunk=s.chunk, u=self.u,
                              s0=ssm_state, chunked=chunked)
        # per-head group norm
        yh = y.float().reshape(B, S, H, dh)
        yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
            yh.var(-1, keepdim=True, unbiased=False) + 1e-5)
        y = yh.reshape(B, S, H * dh) * self.ln_out.float()
        y = (y * F.silu(g.float())).to(x.dtype)
        out = ctx.tap("output", self.out(y))
        return out, {"shift": x[:, -1:], "ssm": new_ssm}


class RWKV6ChannelMix(nn.Module):
    """``rwkv6_init``'s ``channel_mix`` / ``rwkv6_channel_mix``."""

    def __init__(self, gen, cfg: ArchConfig, dtype, out_scale=None):
        super().__init__()
        d = cfg.d_model
        self.mu_k = nn.Parameter(0.5 * torch.ones(d, dtype=torch.float32))
        self.mu_r = nn.Parameter(0.5 * torch.ones(d, dtype=torch.float32))
        self.key = Linear(gen, d, cfg.d_ff, dtype)
        self.value = Linear(gen, cfg.d_ff, d, dtype, scale=out_scale)
        self.recept = Linear(gen, d, d, dtype)

    def forward(self, x, ctx=None, state=None):
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        xx = _token_shift(x, _shift_of(x, state)) - x
        xk = x + xx * self.mu_k.to(x.dtype)
        xr = x + xx * self.mu_r.to(x.dtype)
        kv = self.value(torch.square(F.relu(self.key(xk))))
        out = torch.sigmoid(self.recept(xr).float()).to(x.dtype) * kv
        out = ctx.tap("output", out)
        return out, {"shift": x[:, -1:]}


def rwkv6_init_state(cfg: ArchConfig, batch, dtype, device):
    """Zero decode state of one RWKV-6 block: each mix's trailing token
    (B,1,d) in ``dtype`` and the time mix's scan state (B,H,dh,dh) in f32."""
    H, dh, d = cfg.n_heads, cfg.ssm.d_head, cfg.d_model
    return {
        "time_mix": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                          device=device),
                     "ssm": torch.zeros((batch, H, dh, dh),
                                        dtype=torch.float32, device=device)},
        "channel_mix": {"shift": torch.zeros((batch, 1, d), dtype=dtype,
                                             device=device)},
    }

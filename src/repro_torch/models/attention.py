"""Attention: GQA (full / sliding-window / bidirectional) and Multi-head
Latent Attention, with their one-token decode steps; the port of
``repro/models/attention.py``.

``attention`` routes as the reference does: with ``use_kernel`` to the
flash-attention kernel (``kernels.ops.flash_attention``), else above
S = 2048 to ``attention_blockwise`` (online softmax over 512 x 512 blocks,
each kv step recomputed in the backward), else to ``attention_ref``, which
materializes the scores.  MLA runs in plain ``attention`` and its decode
in ``einsum``, as in the reference: no kernel.

A decode step writes the new token's slot into its cache tensors in place
(``cache[:, pos]``, or ``pos % window`` in a sliding-window ring) and
returns the same dict; the reference's ``dynamic_update_slice`` returns a
new array.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import spans
from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import Linear, apply_rope, rmsnorm

NEG_INF = -1e30


def _mask(mode: str, q_pos, k_pos, window: int):
    """q_pos: (Q,), k_pos: (K,) -> bool (Q,K); True = attend."""
    if mode == "bidirectional":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    m = k_pos[None, :] <= q_pos[:, None]
    if mode == "swa":
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def attention_ref(q, k, v, mode="causal", window=0, q_pos=None, k_pos=None):
    """q: (B,Q,H,D), k/v: (B,K,Hkv,D[v]).  Softmax in fp32 (float64 for
    float64 inputs); GQA reads KV head ``h // G`` without repeating KV."""
    B, Q, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    ct = torch.promote_types(q.dtype, torch.float32)
    if q_pos is None:
        q_pos = torch.arange(Q, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(K, device=q.device)
    qg = q.reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(ct), k.to(ct)) / math.sqrt(D)
    m = _mask(mode, q_pos, k_pos, window)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(ct))
    return o.reshape(B, Q, H, v.shape[-1]).to(q.dtype)


def _kv_step(m_run, l_run, acc, qx, kx, vx, q_pos, k0, mode, window, scale):
    """One kv block of the online softmax; (m, l, acc) are f32."""
    k_pos = k0 + torch.arange(kx.shape[-2], device=kx.device)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qx, kx.float()) * scale
    s = s.masked_fill(~_mask(mode, q_pos, k_pos, window), NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    alpha = torch.exp(m_run - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_run * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                vx.float())
    return m_new, l_new, acc


def attention_blockwise(q, k, v, mode="causal", window=0, q_block=512,
                        kv_block=512):
    """Flash-style two-level loop: O(B*H*qb*kb) peak instead of O(S^2).
    Every kv block is computed (none skipped); each kv step is recomputed
    in the backward instead of keeping its (qb, kb) probabilities."""
    B, S, H, D = q.shape
    K, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    assert S % q_block == 0 and K % kv_block == 0, (S, K, q_block, kv_block)
    nq, nk = S // q_block, K // kv_block
    scale = 1.0 / torch.sqrt(torch.full((), float(D), device=q.device))

    qb = q.reshape(B, nq, q_block, Hkv, G, D).permute(1, 0, 3, 4, 2, 5)
    # (nq, B, Hkv, G, qb, D)
    kb = k.reshape(B, nk, kv_block, Hkv, D).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, kv_block, Hkv, Dv).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qx = qb[qi].float()
        q_pos = qi * q_block + torch.arange(q_block, device=q.device)
        m_run = torch.full((B, Hkv, G, q_block), NEG_INF, device=q.device)
        l_run = torch.zeros((B, Hkv, G, q_block), device=q.device)
        acc = torch.zeros((B, Hkv, G, q_block, Dv), device=q.device)
        for ki in range(nk):
            m_run, l_run, acc = checkpoint(
                _kv_step, m_run, l_run, acc, qx, kb[ki], vb[ki], q_pos,
                ki * kv_block, mode, window, scale, use_reentrant=False,
                preserve_rng_state=False)
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        # cast per q block: the stacked output is kept in the compute dtype
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    # (nq, B, qb, Hkv, G, Dv)
    return torch.stack(outs).transpose(0, 1).reshape(B, S, H, Dv)


def attention(q, k, v, mode="causal", window=0, blockwise_threshold=2048,
              use_kernel=False):
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, mode=mode, window=window)
    if q.shape[1] == k.shape[1] and q.shape[1] > blockwise_threshold:
        return attention_blockwise(q, k, v, mode=mode, window=window)
    return attention_ref(q, k, v, mode=mode, window=window)


class GQAttention(nn.Module):
    """``gqa_init`` / ``_gqa_qkv`` / ``gqa_forward`` with the fused
    ``linear_qkv`` (Megatron naming), biased when ``cfg.qkv_bias``.  With
    ``cfg.qk_norm``, ``q_norm`` and ``k_norm`` (ones of D) RMS-normalize
    each head's q and k after the split and before rope; an ``audio``
    arch takes no rope."""

    def __init__(self, gen, cfg, dtype, out_scale=None):
        super().__init__()
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.cfg = cfg
        self.linear_qkv = Linear(gen, cfg.d_model, (H + 2 * Hkv) * D, dtype,
                                 bias=cfg.qkv_bias)
        self.linear_proj = Linear(gen, H * D, cfg.d_model, dtype,
                                  scale=out_scale)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(D, dtype=dtype))
            self.k_norm = nn.Parameter(torch.ones(D, dtype=dtype))

    def _qkv(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q, k, v = torch.split(self.linear_qkv(x), [H * D, Hkv * D, Hkv * D],
                              dim=-1)
        q = q.reshape(B, S, H, D)
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
        if cfg.qk_norm:
            q = rmsnorm(self.q_norm, q)
            k = rmsnorm(self.k_norm, k)
        if cfg.attn != "none" and cfg.arch_type != "audio":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x, positions=None, ctx=None, use_kernel=False):
        cfg = self.cfg
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self._qkv(x, positions)
        mode = ("bidirectional" if not cfg.causal
                else ("swa" if cfg.attn == "swa" else "causal"))
        o = attention(q, k, v, mode=mode, window=cfg.window,
                      use_kernel=use_kernel)
        o = ctx.tap("core_attn_out", o.reshape(B, S, -1))
        return ctx.tap("output", self.linear_proj(o))

    # ---- decode (one token, KV cache) --------------------------------------

    def decode(self, x, cache, pos: int):
        """``gqa_decode``.  x: (B,1,d_model); ``pos``: the position of the
        new token.  SWA caches are ring buffers of ``window`` slots; softmax
        is invariant to the slot order once positions are in the roped
        keys."""
        cfg = self.cfg
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q, k_new, v_new = self._qkv(x, positions)
        k, v = cache["k"], cache["v"]
        Lc = k.shape[1]
        swa = cfg.attn == "swa"
        if not swa and pos >= Lc:
            raise ValueError(f"position {pos} is past the cache's {Lc} slots")
        slot = pos % Lc
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        idx = torch.arange(Lc, device=x.device)
        valid = (idx <= slot) | (pos >= Lc) if swa else idx <= pos
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        qg = q.reshape(B, 1, Hkv, H // Hkv, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(D)
        s = s.masked_fill(~valid, NEG_INF)
        o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                         v.float())
        o = o.reshape(B, 1, H * D).to(x.dtype)
        return self.linear_proj(o), cache


def gqa_init_cache(cfg, batch, seq_len, dtype, device):
    """K and V caches, (B, L, Hkv, D); L is ``window`` for a sliding-window
    arch with ``seq_len`` past it (a ring buffer)."""
    L = seq_len if cfg.attn != "swa" else min(seq_len, cfg.window)
    shape = (batch, L, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

MLA_DECODE_IMPLS = ("absorbed", "naive")


class MLAttention(nn.Module):
    """``mla_init`` / ``_mla_q`` / ``_mla_ckv`` / ``mla_forward`` and the two
    decode implementations.  Parameter names are the reference's:
    ``linear_dq``, ``q_lora_norm`` and ``linear_uq`` (or ``linear_q`` when
    ``q_lora_rank`` is 0), ``linear_dkv``, ``kv_lora_norm``,
    ``linear_krope``, ``linear_uk``, ``linear_uv``, ``linear_proj``."""

    def __init__(self, gen, cfg, dtype, out_scale=None):
        super().__init__()
        m, H, d = cfg.mla, cfg.n_heads, cfg.d_model
        self.cfg = cfg
        dq = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora_rank:
            self.linear_dq = Linear(gen, d, m.q_lora_rank, dtype)
            self.q_lora_norm = nn.Parameter(torch.ones(m.q_lora_rank,
                                                       dtype=dtype))
            self.linear_uq = Linear(gen, m.q_lora_rank, H * dq, dtype)
        else:
            self.linear_q = Linear(gen, d, H * dq, dtype)
        self.linear_dkv = Linear(gen, d, m.kv_lora_rank, dtype)
        self.kv_lora_norm = nn.Parameter(torch.ones(m.kv_lora_rank,
                                                    dtype=dtype))
        self.linear_krope = Linear(gen, d, m.qk_rope_dim, dtype)
        self.linear_uk = Linear(gen, m.kv_lora_rank, H * m.qk_nope_dim, dtype)
        self.linear_uv = Linear(gen, m.kv_lora_rank, H * m.v_head_dim, dtype)
        self.linear_proj = Linear(gen, H * m.v_head_dim, d, dtype,
                                  scale=out_scale)

    def _q(self, x, positions):
        """(q_nope, roped q_rope), (B,S,H,nope) and (B,S,H,rope)."""
        m, H = self.cfg.mla, self.cfg.n_heads
        B, S, _ = x.shape
        if m.q_lora_rank:
            q = self.linear_uq(rmsnorm(self.q_lora_norm, self.linear_dq(x)))
        else:
            q = self.linear_q(x)
        q = q.reshape(B, S, H, m.qk_nope_dim + m.qk_rope_dim)
        q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
        return q_nope, apply_rope(q_rope, positions, self.cfg.rope_theta)

    def _ckv(self, x, positions):
        """(normed latent (B,S,kv_lora), roped shared key (B,S,rope))."""
        ckv = rmsnorm(self.kv_lora_norm, self.linear_dkv(x))
        k_rope = apply_rope(self.linear_krope(x), positions,
                            self.cfg.rope_theta)
        return ckv, k_rope

    def _heads(self, ckv, k_rope, q_nope, q_rope):
        """Per-head q (B,Q,H,nope+rope), k (B,S,H,nope+rope) and v
        (B,S,H,v) materialized from the latent."""
        m, H = self.cfg.mla, self.cfg.n_heads
        B, S, _ = ckv.shape
        k_nope = self.linear_uk(ckv).reshape(B, S, H, m.qk_nope_dim)
        v = self.linear_uv(ckv).reshape(B, S, H, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.qk_rope_dim)], dim=-1)
        return q, k, v

    def forward(self, x, positions=None, ctx=None, use_kernel=False):
        """``mla_forward``, the training / prefill path: per-head K/V
        materialized from the latent, attention in ``attention``; under a
        check its forward and backward are the span ``mla``."""
        if use_kernel:
            raise ValueError("MLA has no flash-kernel path (the reference's "
                             "mla_forward takes no use_kernel)")
        ctx = ensure_ctx(ctx)
        with spans.span("mla") as sp:
            x = sp.grad_end(ctx.tap("input", x))
            B, S, _ = x.shape
            if positions is None:
                positions = torch.arange(S, device=x.device).expand(B, S)
            q_nope, q_rope = self._q(x, positions)
            q, k, v = self._heads(*self._ckv(x, positions), q_nope, q_rope)
            o = attention(q, k, v, mode="causal")
            o = ctx.tap("core_attn_out", o.reshape(B, S, -1))
            return sp.grad_start(ctx.tap("output", self.linear_proj(o)))

    # ---- decode (one token, latent cache) ----------------------------------

    def _write(self, x, cache, pos, positions):
        ckv_new, krope_new = self._ckv(x, positions)
        ckv, krope = cache["ckv"], cache["krope"]
        if pos >= ckv.shape[1]:
            raise ValueError(f"position {pos} is past the cache's "
                             f"{ckv.shape[1]} slots")
        ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
        krope[:, pos] = krope_new[:, 0].to(krope.dtype)
        return ckv, krope

    def decode(self, x, cache, pos: int, impl="absorbed", bugs=frozenset()):
        """One token: ``mla_decode_absorbed`` (the production path,
        ``impl="absorbed"``) or ``mla_decode_naive`` (``impl="naive"``, the
        independent inference-TTrace reference).  ``bugs`` may hold
        ``decode_stale_rope_pos`` (absorbed only): the query rope uses
        position ``max(pos - 1, 0)``; the key rope stays right."""
        if impl not in MLA_DECODE_IMPLS:
            raise ValueError(f"unknown MLA decode impl {impl!r}")
        if impl == "naive":
            if bugs:
                raise ValueError(f"the naive MLA decode takes no bugs "
                                 f"(got {sorted(bugs)})")
            return self.decode_naive(x, cache, pos)
        return self.decode_absorbed(x, cache, pos, bugs=bugs)

    def decode_naive(self, x, cache, pos: int):
        """Materializes per-head K/V from the whole latent cache and runs
        standard attention over it."""
        m, H = self.cfg.mla, self.cfg.n_heads
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q_nope, q_rope = self._q(x, positions)
        ckv, krope = self._write(x, cache, pos, positions)
        S = ckv.shape[1]
        q, k, v = self._heads(ckv, krope, q_nope, q_rope)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(
            m.qk_nope_dim + m.qk_rope_dim)
        s = s.masked_fill(~(torch.arange(S, device=x.device) <= pos), NEG_INF)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                         v.float())
        o = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
        return self.linear_proj(o), cache

    def decode_absorbed(self, x, cache, pos: int, bugs=frozenset()):
        """Attention in the kv_lora latent space: ``linear_uk`` is absorbed
        into the query and ``linear_uv`` applied after, so the cache holds
        only (kv_lora + rope) values a token.  ``linear_uk.w`` is
        (kv_lora, H * nope) like the reference's, so its (kv_lora, H, nope)
        view keeps the heads in order."""
        m, H = self.cfg.mla, self.cfg.n_heads
        r = m.kv_lora_rank
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        qpos = (torch.clamp(positions - 1, min=0)
                if "decode_stale_rope_pos" in bugs else positions)
        q_nope, q_rope = self._q(x, qpos)                      # (B,1,H,*)
        ckv, krope = self._write(x, cache, pos, positions)
        S = ckv.shape[1]
        wuk = self.linear_uk.w.reshape(r, H, m.qk_nope_dim)
        # absorb W_uk into q: q_lat[b,h,r] = sum_d q_nope[b,h,d] wuk[r,h,d]
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wuk.float())
        s = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv.float())
             + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), krope.float()))
        s = s / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
        s = s.masked_fill(~(torch.arange(S, device=x.device) <= pos), NEG_INF)
        ctx_lat = torch.einsum("bhqk,bkr->bqhr", torch.softmax(s, dim=-1),
                               ckv.float())
        wuv = self.linear_uv.w.reshape(r, H, m.v_head_dim)
        o = torch.einsum("bqhr,rhd->bqhd", ctx_lat, wuv.float())
        o = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
        return self.linear_proj(o), cache


def mla_init_cache(cfg, batch, seq_len, dtype, device):
    """The latent cache: ``ckv`` (B, L, kv_lora) and ``krope`` (B, L,
    rope), kv_lora + rope values a token instead of H * (nope + v)."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, seq_len, m.qk_rope_dim), dtype=dtype,
                                 device=device)}

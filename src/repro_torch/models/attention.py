"""GQA attention (full / sliding-window / bidirectional): the port of the
dense part of ``repro/models/attention.py``.

``attention`` routes as the reference does: with ``use_kernel`` to the
flash-attention kernel (``kernels.ops.flash_attention``), else above
S = 2048 to ``attention_blockwise`` (online softmax over 512 x 512 blocks,
each kv step recomputed in the backward), else to ``attention_ref``, which
materializes the scores.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tap import ensure_ctx
from repro_torch.models.layers import Linear, apply_rope

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
    ``linear_qkv`` (Megatron naming).  ``qk_norm`` and ``qkv_bias`` arrive
    with the first ported config that sets them."""

    def __init__(self, gen, cfg, dtype, out_scale=None):
        super().__init__()
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.cfg = cfg
        self.linear_qkv = Linear(gen, cfg.d_model, (H + 2 * Hkv) * D, dtype)
        self.linear_proj = Linear(gen, H * D, cfg.d_model, dtype,
                                  scale=out_scale)

    def _qkv(self, x, positions):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q, k, v = torch.split(self.linear_qkv(x), [H * D, Hkv * D, Hkv * D],
                              dim=-1)
        q = q.reshape(B, S, H, D)
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
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

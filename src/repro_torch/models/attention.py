"""GQA attention (full / sliding-window / bidirectional): the port of the
dense part of ``repro/models/attention.py``.

``attention_ref`` materializes the scores, as the reference does up to
S = 2048.  Above that the reference switches to ``attention_blockwise``,
which the port does not have yet; the flash-attention kernel the
reference reaches with ``use_kernel=True`` is not ported either.
"""
from __future__ import annotations

import math

import torch
from torch import nn

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
    """q: (B,Q,H,D), k/v: (B,K,Hkv,D[v]).  Softmax in fp32; GQA reads KV
    head ``h // G`` without repeating KV."""
    B, Q, H, D = q.shape
    K, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if q_pos is None:
        q_pos = torch.arange(Q, device=q.device)
    if k_pos is None:
        k_pos = torch.arange(K, device=q.device)
    qg = q.reshape(B, Q, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(D)
    m = _mask(mode, q_pos, k_pos, window)
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Q, H, v.shape[-1]).to(q.dtype)


def attention(q, k, v, mode="causal", window=0, blockwise_threshold=2048):
    if q.shape[1] == k.shape[1] and q.shape[1] > blockwise_threshold:
        raise NotImplementedError(
            "attention_blockwise (S > 2048) is not ported yet")
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

    def forward(self, x, positions=None, ctx=None):
        cfg = self.cfg
        ctx = ensure_ctx(ctx)
        x = ctx.tap("input", x)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        q, k, v = self._qkv(x, positions)
        mode = ("bidirectional" if not cfg.causal
                else ("swa" if cfg.attn == "swa" else "causal"))
        o = attention(q, k, v, mode=mode, window=cfg.window)
        o = ctx.tap("core_attn_out", o.reshape(B, S, -1))
        return ctx.tap("output", self.linear_proj(o))

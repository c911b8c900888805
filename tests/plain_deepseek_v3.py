"""A plain float32 DeepSeek-V3 decoder for the port's CPU tests: plain
``torch`` only, nothing of the port, of JAX or of any kernel.

``loss(params, tokens, labels, hp)`` is one training step's loss over
``params`` (``{flat name: tensor}`` in the port's names and its (d_in,
d_out) layout) and ``adamw_first_step`` the first AdamW step after it;
``moe_layer`` is one MoE layer, of a held share of the experts or of all.
``hp`` holds the hyperparameters by name (``d_model``, ``n_heads``,
``kv_lora_rank``, ``qk_nope_dim``, ``qk_rope_dim``, ``v_head_dim``,
``rope_theta``, ``n_dense_layers``, ``n_moe_layers``, ``n_experts``,
``top_k``, ``n_held``, ``held_offset``, ``capacity_factor``,
``routed_scaling_factor``, ``aux_coef``).

The equations (arXiv:2412.19437; Moonlight-16B-A3B's config.json): ``h =
x + MLA(rms(x))``, ``y = h + FFN(rms(h))``.  MLA: ``q = W_q x`` split per
head into ``q_nope`` and ``q_pe``; ``c = rms(W_dkv x)``, ``k_pe = W_krope
x`` shared by all heads; ``k_nope = W_uk c`` and ``v = W_uv c`` per head;
``q_pe`` and ``k_pe`` roped; causal softmax of ``[q_nope, q_pe] . [k_nope,
k_pe] / sqrt(nope + rope)`` over ``v``, then ``W_o``.  The router: ``s =
sigmoid(x W_r)`` in f32 over all experts; the top k of ``s + b`` chosen
(``b`` selects, never weighs; ties to the lower expert); weights
``scale * s_i / sum_chosen s``; ``FFN = sum_chosen g_i E_i(x) +
Shared(x)``, where a held expert keeps the first ``capacity`` of its
assignments in token order and an absent one adds nothing.  The balance
loss, per sequence: ``f_i = E / (k S) * #{t : i chosen}``, ``P_i = mean_t
s_it / sum_j s_jt``, ``aux_coef * sum_i f_i P_i``, meaned over sequences.

Departures, shared with the port: rope rotates the pairs (2i, 2i+1);
every RMS norm takes eps 1e-5; the chosen scores' sum is clamped at 1e-9;
the layer has a capacity; matrices are (d_in, d_out).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-5


def rms(x, w):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + EPS) * w


def rope(x, theta):
    """``x`` (B, S, H, D) rotated by position: pairs (2i, 2i+1) by ``pos *
    theta^(-2i/D)``."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def swiglu(x, gate, up, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def mla(h, p, hp):
    B, S, _ = h.shape
    H, nope, rd, vd = (hp["n_heads"], hp["qk_nope_dim"], hp["qk_rope_dim"],
                       hp["v_head_dim"])
    q = (h @ p["linear_q.w"]).reshape(B, S, H, nope + rd)
    q_nope, q_pe = q.split([nope, rd], -1)
    c = rms(h @ p["linear_dkv.w"], p["kv_lora_norm"])
    k_pe = rope((h @ p["linear_krope.w"])[:, :, None], hp["rope_theta"])
    k = torch.cat([(c @ p["linear_uk.w"]).reshape(B, S, H, nope),
                   k_pe.expand(B, S, H, rd)], -1)
    v = (c @ p["linear_uv.w"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, rope(q_pe, hp["rope_theta"])], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(nope + rd)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    a = torch.softmax(s.masked_fill(~keep, -1e30), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, H * vd)
    return o @ p["linear_proj.w"]


def route(s, bias, hp):
    """``(weights, chosen)`` of f32 scores ``s`` (T, E)."""
    key = s if bias is None else s + bias
    top_e = torch.sort(key, dim=-1, descending=True, stable=True).indices[
        :, :hp["top_k"]]
    top_p = torch.gather(s, -1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_p * hp["routed_scaling_factor"], top_e


def capacity(T, hp):
    cap = int(max(1, hp["capacity_factor"] * T * hp["top_k"]
                  / hp["n_experts"]))
    return -(-cap // 512) * 512 if cap > 512 else cap


def moe_layer(h, p, hp, n_held=None, held_offset=None):
    """``(y, aux)`` of one MoE layer over ``h`` (B, S, d): the experts
    ``p["experts.*"]`` are the ``n_held`` from ``held_offset`` (default
    ``hp``'s); the shared experts are added whole."""
    n_held = hp["n_held"] if n_held is None else n_held
    off = hp["held_offset"] if held_offset is None else held_offset
    B, S, d = h.shape
    T, E, k = B * S, hp["n_experts"], hp["top_k"]
    x = h.reshape(T, d)
    s = torch.sigmoid(x @ p["router"])
    top_p, top_e = route(s, p.get("score_correction.b"), hp)
    P = (s / s.sum(-1, keepdim=True)).reshape(B, S, E).mean(1)
    n = F.one_hot(top_e.reshape(B, S * k), E).sum(1).float()
    aux = hp["aux_coef"] * torch.mean(torch.sum(E / (k * S) * n * P, -1))
    cap = capacity(T, hp)
    y = torch.zeros(T, d)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    for j in range(n_held):
        kept = torch.nonzero(flat_e == off + j)[:cap, 0]
        out = swiglu(x[kept // k], p["experts.gate"][j], p["experts.up"][j],
                     p["experts.down"][j])
        y = y.index_add(0, kept // k, out * flat_p[kept][:, None])
    y = y.reshape(B, S, d) + swiglu(h, p["shared.gate.w"], p["shared.up.w"],
                                    p["shared.down.w"])
    return y, aux


def _sub(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def loss(params, tokens, labels, hp):
    """Mean next-token cross-entropy plus the MoE layers' balance losses."""
    x = params["embedding.word_embeddings"][tokens]
    aux = 0.0
    names = ([f"dense_layers.{i}." for i in range(hp["n_dense_layers"])]
             + [f"layers.{j}." for j in range(hp["n_moe_layers"])])
    for name in names:
        p = _sub(params, name)
        x = x + mla(rms(x, p["input_norm"]), _sub(p, "self_attention."), hp)
        h = rms(x, p["post_attn_norm"])
        m = _sub(p, "mlp.")
        if name.startswith("dense"):
            x = x + swiglu(h, m["gate.w"], m["up.w"], m["down.w"])
        else:
            y, a = moe_layer(h, m, hp)
            x, aux = x + y, aux + a
    logits = rms(x, params["final_norm"]) @ params["lm_head"].t()
    ce = torch.mean(torch.logsumexp(logits, -1)
                    - torch.gather(logits, -1, labels[..., None])[..., 0])
    return ce + aux


def adamw_first_step(params, grads, lr, b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.01, clip=1.0):
    """The first AdamW step from zero moments, the global gradient norm
    clipped to ``clip``; norms and biases (a leaf named ``*norm`` or
    ``b``) take no weight decay."""
    total = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                          for g in grads.values()))
    scale = min(1.0, clip / max(total, 1e-12))
    out = {}
    for k, p in params.items():
        g = grads[k] * scale
        u = g / (torch.sqrt(g * g) + eps)
        last = k.rsplit(".", 1)[-1]
        if weight_decay and not (last.endswith("norm") or last == "b"):
            u = u + weight_decay * p
        out[k] = p - lr * u
    return out

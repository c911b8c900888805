"""Plain float32 reference of a DeepSeek-V3 decoder (arXiv:2412.19437;
Moonlight-16B-A3B's config.json, model_type deepseek_v3): pre-norm
blocks of multi-head latent attention, then a dense SwiGLU MLP in the
first ``first_k_dense_replace`` layers and a sparse mixture of SwiGLU
experts beside shared experts in the rest; RMS norms, untied input and
output embeddings.

Latent attention, per layer: ``q = W_q x`` split per head into ``q_nope``
and ``q_pe``; ``c = rms(W_dkv x)`` (``kv_lora_rank``) and the rope key
``k_pe = W_krope x``, one for all heads; ``k_nope = W_uk c``, ``v = W_uv
c`` per head; ``q_pe`` and ``k_pe`` roped; causal softmax of ``[q_nope,
q_pe] . [k_nope, k_pe] / sqrt(nope + rope)`` over ``v``, then ``W_o``.
The attention runs one sequence at a time under ``torch.utils.checkpoint``
(nothing of it kept for the backward but its inputs), so that the
float32 (S, S) scores of a whole batch are never held at once.

The mixture: float32 scores ``s = sigmoid(x W_r)`` over all of the
router's experts (``router_experts``); each token chooses the
``num_experts_per_tok`` largest of ``s + b`` (``b`` the score-correction
bias, which selects and never weighs; ties to the lower expert), weighs
them by ``routed_scaling_factor * s_i / sum of the chosen s``, and adds
the weighted SwiGLU outputs of those of them this configuration holds
(``n_routed_experts`` from ``held_offset``), then the shared experts'
SwiGLU (``n_shared_experts`` times the expert width) of every token.  A
held expert takes at most ``capacity`` of its assignments, the first in
token order over the whole batch (``capacity = int(capacity_factor * T
* k / E)`` over all ``E`` of the router's experts, rounded up to a
multiple of 512 above 512); a dropped assignment adds nothing.  The
sequence-wise balance loss (eqs. 17-20): for each sequence, ``f_i = E /
(k S) * #{t : i chosen at t}`` and ``P_i = mean_t s_it / sum_j s_jt``;
``aux_loss_alpha * sum_i f_i P_i``, meaned over the sequences, joins the
cross-entropy.  The bias joins the loss times zero, so that its gradient
is a tensor of zeros, as the program records for it.

Departures from the published description, all shared with the program:
the rotary embedding rotates the pairs (2i, 2i+1) of ``q_pe`` and
``k_pe`` (DeepSeek's code rotates (i, i + D/2) after permuting them: with
random weights a fixed permutation of ``W_q``'s and ``W_krope``'s
columns); the latent's RMS norm takes eps 1e-5, as every norm of the
program; the chosen scores' sum is clamped at 1e-9 (DeepSeek adds 1e-20);
Moonlight routes without a capacity (at this benchmark's batches no held
expert reaches it); the bias stays as drawn, where DeepSeek-V3 moves it
between steps by the load it saw (a one-step check never reaches that
update); only the held experts compute, the absent experts' part of each
layer's output is left out; the matrices are stored (d_in, d_out).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from port_bench.reference import common


def capacity(n_tokens: int, cfg) -> int:
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    cf = cfg["capacity_factor"]
    if cf <= 0:
        return n_tokens
    cap = int(max(1, cf * n_tokens * k / E))
    return -(-cap // 512) * 512 if cap > 512 else cap


def _prefix(cfg, i: int) -> str:
    """The parameter prefix of layer ``i``: the program names its leading
    dense layers ``dense_layers.{i}`` and its MoE layers ``layers.{j}``
    from 0 (its taps use ``layers.{i}`` throughout)."""
    nd = cfg["first_k_dense_replace"]
    return f"dense_layers.{i}." if i < nd else f"layers.{i - nd}."


def param_specs(cfg) -> list:
    """``(name, shape, dtype, mean, std)`` of every leaf, in the program's
    names; linear weights are (d_in, d_out)."""
    d, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    E, held = cfg["router_experts"], cfg["n_routed_experts"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs = cfg["n_shared_experts"] * fe
    bf, f32 = getattr(torch, cfg["torch_dtype"]), torch.float32
    out = common.out_std(cfg)
    specs = [("embedding.word_embeddings", (V, d), bf, 0.0, 0.02),
             ("final_norm", (d,), bf, 1.0, 0.02),
             ("lm_head", (V, d), bf, 0.0, 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        p = _prefix(cfg, i)
        a = p + "self_attention."
        specs += [(p + "input_norm", (d,), bf, 1.0, 0.02),
                  (p + "post_attn_norm", (d,), bf, 1.0, 0.02),
                  (a + "linear_q.w", (d, H * (nope + rope)), bf, 0.0, 0.02),
                  (a + "linear_dkv.w", (d, r), bf, 0.0, 0.02),
                  (a + "kv_lora_norm", (r,), bf, 1.0, 0.02),
                  (a + "linear_krope.w", (d, rope), bf, 0.0, 0.02),
                  (a + "linear_uk.w", (r, H * nope), bf, 0.0, 0.02),
                  (a + "linear_uv.w", (r, H * vd), bf, 0.0, 0.02),
                  (a + "linear_proj.w", (H * vd, d), bf, 0.0, out)]
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            specs += [(m + "gate.w", (d, f), bf, 0.0, 0.02),
                      (m + "up.w", (d, f), bf, 0.0, 0.02),
                      (m + "down.w", (f, d), bf, 0.0, out)]
            continue
        specs += [(m + "router", (d, E), f32, 0.0, 0.02),
                  (m + "score_correction.b", (E,), f32, 0.0,
                   cfg["score_correction_std"]),
                  (m + "experts.gate", (held, d, fe), bf, 0.0, 0.02),
                  (m + "experts.up", (held, d, fe), bf, 0.0, 0.02),
                  (m + "experts.down", (held, fe, d), bf, 0.0, out),
                  (m + "shared.gate.w", (d, fs), bf, 0.0, 0.02),
                  (m + "shared.up.w", (d, fs), bf, 0.0, 0.02),
                  (m + "shared.down.w", (fs, d), bf, 0.0, out)]
    return specs


def _causal(mm, q, k, v):
    """One sequence's causal softmax attention: ``q``, ``k`` (S, H, Dq),
    ``v`` (S, H, Dv) -> (S, H * Dv)."""
    S, H, D = q.shape
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    keep = pos[None, :] <= pos[:, None]
    p = torch.softmax(s.masked_fill(~keep, common.NEG_INF), dim=-1)
    return mm(p, v.transpose(0, 1)).transpose(0, 1).reshape(S, -1)


def mla(mm, h, params, a, cfg):
    B, S, _ = h.shape
    H, nope = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    theta, eps = cfg["rope_theta"], cfg["rms_norm_eps"]
    q = common.linear(mm, h, params[a + "linear_q.w"]).reshape(
        B, S, H, nope + rope)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    c = common.rmsnorm(common.linear(mm, h, params[a + "linear_dkv.w"]),
                       params[a + "kv_lora_norm"], eps)
    k_pe = common.rope(common.linear(mm, h, params[a + "linear_krope.w"])
                       [:, :, None, :], theta)
    k_nope = common.linear(mm, c, params[a + "linear_uk.w"]).reshape(
        B, S, H, nope)
    v = common.linear(mm, c, params[a + "linear_uv.w"]).reshape(B, S, H, vd)
    q = torch.cat([q_nope, common.rope(q_pe, theta)], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], dim=-1)
    return torch.stack([
        checkpoint(_causal, mm, q[b], k[b], v[b], use_reentrant=False,
                   preserve_rng_state=False) for b in range(B)])


def moe(mm, h, params, m, cfg, taps, tap):
    B, S, d = h.shape
    T = B * S
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    off, held = cfg["held_offset"], cfg["n_routed_experts"]
    xt = h.reshape(T, d)
    taps[tap + "mlp/router_logits"] = mm(xt, params[m + "router"]).reshape(
        B, S, E)
    s = torch.sigmoid(taps[tap + "mlp/router_logits"].reshape(T, E))
    bias = params[m + "score_correction.b"]
    top_e = torch.sort(s + bias, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    top_p = torch.gather(s, -1, top_e)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    top_p = top_p * cfg["routed_scaling_factor"]
    # the sequence-wise balance loss
    P = (s / s.sum(-1, keepdim=True)).reshape(B, S, E).mean(1)
    chosen = top_e.reshape(B, S * k)
    n = torch.stack([(chosen == e).sum(-1) for e in range(E)], -1).float()
    aux = torch.mean(torch.sum(E / (k * S) * n * P, -1)) * cfg[
        "aux_loss_alpha"]
    cap = capacity(T, cfg)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    y = torch.zeros(T, d, dtype=h.dtype, device=h.device)
    for j in range(held):
        kept = torch.nonzero(flat_e == off + j)[:cap, 0]   # token order
        if not len(kept):
            continue
        tok = kept // k
        out = common.swiglu(mm, xt[tok], params[m + "experts.gate"][j],
                            params[m + "experts.up"][j],
                            params[m + "experts.down"][j])
        y = y.index_add(0, tok, out * flat_p[kept][:, None])
    y = y.reshape(B, S, d) + common.swiglu(
        mm, h, params[m + "shared.gate.w"], params[m + "shared.up.w"],
        params[m + "shared.down.w"])
    return y, aux + 0.0 * bias.sum()


def forward(params, batch, cfg, mm, emb_delta=None):
    """``(loss, taps)``; ``taps`` holds the tensors the comparison reads,
    under the names the program gives them."""
    tokens, labels = batch["tokens"], batch["labels"]
    eps = cfg["rms_norm_eps"]
    taps = {}
    x = params["embedding.word_embeddings"][tokens]
    if emb_delta is not None:
        x = emb_delta(x)
    taps["embedding/output"] = x
    aux_total = None
    for i in range(cfg["num_hidden_layers"]):
        p, t = _prefix(cfg, i), f"layers.{i}."
        h = common.rmsnorm(x, params[p + "input_norm"], eps)
        taps[t + "self_attention/input"] = h
        o = mla(mm, h, params, p + "self_attention.", cfg)
        taps[t + "self_attention/core_attn_out"] = o
        a = common.linear(mm, o, params[p + "self_attention.linear_proj.w"])
        taps[t + "self_attention/output"] = a
        x = x + a
        h = common.rmsnorm(x, params[p + "post_attn_norm"], eps)
        taps[t + "mlp/input"] = h
        if i < cfg["first_k_dense_replace"]:
            y = common.swiglu(mm, h, params[p + "mlp.gate.w"],
                              params[p + "mlp.up.w"], params[p + "mlp.down.w"])
        else:
            y, aux = moe(mm, h, params, p + "mlp.", cfg, taps, t)
            aux_total = aux if aux_total is None else aux_total + aux
        taps[t + "mlp/output"] = y
        x = x + y
    h = common.rmsnorm(x, params["final_norm"], eps)
    taps["final_norm_out"] = h
    loss = common.cross_entropy(common.linear(mm, h, params["lm_head"].t()),
                                labels)
    return (loss if aux_total is None else loss + aux_total), taps


def port_fields(cfg) -> dict:
    """The program's configuration fields this configuration sets (its
    latent attention's widths are the program's ``moonlight-16b-a3b``'s,
    the published ones).  The program's sigmoid router always renormalizes
    the chosen scores and balances per sequence."""
    if not (cfg["norm_topk_prob"] and cfg["seq_aux"]):
        raise ValueError("the program's sigmoid router needs norm_topk_prob "
                         "and seq_aux")
    return dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                n_heads=cfg["num_attention_heads"],
                n_kv_heads=cfg["num_key_value_heads"],
                d_ff=cfg["moe_intermediate_size"], vocab=cfg["vocab_size"],
                rope_theta=float(cfg["rope_theta"]),
                tie_embeddings=cfg["tie_word_embeddings"], attn="mla",
                window=0, param_dtype=cfg["torch_dtype"],
                compute_dtype=cfg["compute_dtype"],
                moe=dict(n_experts=cfg["router_experts"],
                         top_k=cfg["num_experts_per_tok"],
                         n_shared=cfg["n_shared_experts"],
                         d_ff_expert=cfg["moe_intermediate_size"],
                         d_ff_dense=cfg["intermediate_size"],
                         n_dense_layers=cfg["first_k_dense_replace"],
                         capacity_factor=cfg["capacity_factor"],
                         router_aux_coef=cfg["aux_loss_alpha"],
                         scoring=cfg["scoring_func"],
                         routed_scaling_factor=cfg["routed_scaling_factor"],
                         n_held=cfg["n_routed_experts"],
                         held_offset=cfg["held_offset"]))

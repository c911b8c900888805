"""Plain float32 reference of a Mixtral decoder (arXiv:2401.04088):
pre-norm blocks of rotary grouped-query attention over a sliding window
and a sparse mixture of SwiGLU experts, RMS norms.

The mixture: a float32 router gives each token's softmax over the
experts; its ``num_experts_per_tok`` largest (ties to the lower expert)
are renormalized to sum to one, and the token's output is their weighted
sum of those experts' SwiGLU outputs.  An expert takes at most
``capacity`` of its assignments, the first in token order (``capacity =
int(capacity_factor * T * k / E)``, rounded up to a multiple of 512 above
512); a dropped assignment adds nothing.  The load-balancing loss ``E *
sum_e mean_t(p_e) * n_e / (T k)`` times ``router_aux_loss_coef`` joins the
cross-entropy.

Departures from the published description, all shared with the program:
the rotary embedding rotates the pairs (2i, 2i+1) of a head (Hugging
Face's code rotates (i, i + D/2)); Mixtral routes without a capacity (at
the batches of this benchmark no expert reaches it); the matrices are
stored (d_in, d_out).
"""
from __future__ import annotations

import torch

from port_bench.reference import common


def capacity(n_tokens: int, cfg) -> int:
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    cf = cfg["capacity_factor"]
    if cf <= 0:
        return n_tokens
    cap = int(max(1, cf * n_tokens * k / E))
    return -(-cap // 512) * 512 if cap > 512 else cap


def _mlp_specs(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    E = cfg["num_local_experts"]
    bf = getattr(torch, cfg["torch_dtype"])

    def specs(p):
        return [(p + "router", (d, E), torch.float32, 0.0, 0.02),
                (p + "experts.gate", (E, d, f), bf, 0.0, 0.02),
                (p + "experts.up", (E, d, f), bf, 0.0, 0.02),
                (p + "experts.down", (E, f, d), bf, 0.0, common.out_std(cfg))]
    return specs


def param_specs(cfg) -> list:
    return common.decoder_specs(cfg, False, _mlp_specs(cfg))


def moe(mm, h, params, p, cfg, taps):
    B, S, d = h.shape
    T = B * S
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    xt = h.reshape(T, d)
    taps[p + "mlp/router_logits"] = mm(xt, params[p + "mlp.router"]).reshape(
        B, S, E)
    logits = taps[p + "mlp/router_logits"].reshape(T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    counts = torch.stack([(top_e == e).sum() for e in range(E)]).float()
    aux = (E * torch.sum(probs.mean(0) * counts / (T * k))
           * cfg["router_aux_loss_coef"])
    cap = capacity(T, cfg)
    flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
    y = torch.zeros(T, d, dtype=h.dtype, device=h.device)
    for e in range(E):
        kept = torch.nonzero(flat_e == e)[:cap, 0]   # assignments, token order
        tok = kept // k
        out = common.swiglu(mm, xt[tok], params[p + "mlp.experts.gate"][e],
                            params[p + "mlp.experts.up"][e],
                            params[p + "mlp.experts.down"][e])
        y = y.index_add(0, tok, out * flat_p[kept][:, None])
    return y.reshape(B, S, d), aux


def forward(params, batch, cfg, mm, emb_delta=None):
    def mlp(h, p, taps):
        return moe(mm, h, params, p, cfg, taps)

    return common.decoder_forward(params, batch, cfg, mm, mlp, emb_delta)


def port_fields(cfg) -> dict:
    """The program's configuration fields this configuration sets."""
    return dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                n_heads=cfg["num_attention_heads"],
                n_kv_heads=cfg["num_key_value_heads"],
                d_head=cfg["hidden_size"] // cfg["num_attention_heads"],
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                rope_theta=float(cfg["rope_theta"]),
                tie_embeddings=cfg["tie_word_embeddings"],
                attn="swa" if cfg.get("sliding_window") else "full",
                window=cfg.get("sliding_window") or 0,
                param_dtype=cfg["torch_dtype"],
                compute_dtype=cfg["compute_dtype"],
                moe=dict(n_experts=cfg["num_local_experts"],
                         top_k=cfg["num_experts_per_tok"],
                         d_ff_expert=cfg["intermediate_size"],
                         capacity_factor=cfg["capacity_factor"],
                         router_aux_coef=cfg["router_aux_loss_coef"]))

"""Plain float32 reference of a Qwen1.5 decoder (CodeQwen1.5-7B): pre-norm
blocks of rotary multi-head attention with biased q, k and v projections
and a SwiGLU MLP, RMS norms, untied input and output embeddings.

Departures from the published description, all shared with the program:
the rotary embedding rotates the pairs (2i, 2i+1) of a head, where
Hugging Face's Qwen2 code rotates (i, i + D/2), a fixed permutation of
each head's q and k columns; the MLP's three matrices and the fused
q | k | v matrix are stored (d_in, d_out).
"""
from __future__ import annotations

import torch

from port_bench.reference import common


def _mlp_specs(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    dt = getattr(torch, cfg["torch_dtype"])

    def specs(p):
        return [(p + "gate.w", (d, f), dt, 0.0, 0.02),
                (p + "up.w", (d, f), dt, 0.0, 0.02),
                (p + "down.w", (f, d), dt, 0.0,
                 common.out_std(cfg))]
    return specs


def param_specs(cfg) -> list:
    return common.decoder_specs(cfg, True, _mlp_specs(cfg))


def forward(params, batch, cfg, mm, emb_delta=None):
    def mlp(h, p, taps):
        return common.swiglu(mm, h, params[p + "mlp.gate.w"],
                             params[p + "mlp.up.w"],
                             params[p + "mlp.down.w"]), None

    return common.decoder_forward(params, batch, cfg, mm, mlp, emb_delta)


def port_fields(cfg) -> dict:
    """The program's configuration fields this configuration sets."""
    return dict(n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
                n_heads=cfg["num_attention_heads"],
                n_kv_heads=cfg["num_key_value_heads"],
                d_head=cfg["hidden_size"] // cfg["num_attention_heads"],
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                qkv_bias=True, rope_theta=float(cfg["rope_theta"]),
                tie_embeddings=cfg["tie_word_embeddings"], attn="full",
                window=0, param_dtype=cfg["torch_dtype"],
                compute_dtype=cfg["compute_dtype"])

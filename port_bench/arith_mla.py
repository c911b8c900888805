"""Model FLOPs of a DeepSeek-V3 training step (``reference/deepseek_v3.py``'s
configurations), from shapes alone, for ``mfu.check.mla``.

The convention is ``arith.py``'s: each matrix product of the forward
counted once (``2 m n k``) and the backward as twice the forward; the
attention's two products over all ``S x S`` query-key pairs (at the
query-key width ``nope + rope`` and the value width); the optimizer and
every elementwise op as nothing; no recomputation.  Latent attention's
projections count at their ranks; the dense layers and the shared experts
at every token; the held routed experts at the rows routing gives them on
average, ``T * k * held / E`` (or ``expert_rows``, e.g. the rows of their
capacity buffers, which is what the program multiplies); the router over
all ``E`` experts; the head over the vocabulary's slice.
"""
from __future__ import annotations


def mla_flops(cfg: dict, B: int, S: int) -> int:
    """One latent attention's forward: projections and the S x S core."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, vd = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    qr = cfg.get("q_lora_rank") or 0
    T = B * S
    q = (2 * T * d * qr + 2 * T * qr * H * (nope + rope) if qr
         else 2 * T * d * H * (nope + rope))
    proj = (q + 2 * T * d * (r + rope) + 2 * T * r * H * (nope + vd)
            + 2 * T * H * vd * d)
    return proj + 2 * B * H * S * S * (nope + rope + vd)


def forward_flops(cfg: dict, B: int, S: int, expert_rows=None) -> int:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    E, held = cfg["router_experts"], cfg["n_routed_experts"]
    k, fe = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    T = B * S
    L, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    rows = T * k * held / E if expert_rows is None else expert_rows
    dense = 3 * 2 * T * d * cfg["intermediate_size"]
    moe = (2 * T * d * E + 3 * 2 * T * d * cfg["n_shared_experts"] * fe
           + 3 * 2 * rows * d * fe)
    return int(L * mla_flops(cfg, B, S) + nd * dense + (L - nd) * moe
               + 2 * T * d * V)


def step_flops(cfg: dict, B: int, S: int, expert_rows=None) -> int:
    """Forward and backward of one training step."""
    return 3 * forward_flops(cfg, B, S, expert_rows)

"""Moonlight-16B-A3B — DeepSeek-V3's block at 16 B parameters.
[hf:moonshotai/Moonlight-16B-A3B, config.json, model_type deepseek_v3]

27L d_model=2048 16H, MLA (full-rank q, kv_lora_rank=512, nope 128,
rope 64, v 128), rope_theta 50000, vocab 163840 untied.  The first layer
is dense (SwiGLU 11264); the other 26 are MoE: 64 routed experts of 1408
under a sigmoid router whose score-correction bias chooses the top 6
(``noaux_tc``, one group), the chosen scores renormalized and scaled by
2.446, plus 2 shared experts, and a sequence-wise balance loss.  A
port-only config: the reference package has no DeepSeek-V3 router.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="moonlight-16b-a3b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,                       # expert hidden size
    vocab=163_840,
    attn="mla",
    rope_theta=50_000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  d_ff_dense=11264, n_dense_layers=1, router_aux_coef=0.001,
                  scoring="sigmoid", routed_scaling_factor=2.446),
    param_dtype="bfloat16",
    source="https://huggingface.co/moonshotai/Moonlight-16B-A3B",
))

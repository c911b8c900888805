"""DeepSeek-V2 236B — MoE with Multi-head Latent Attention. [arXiv:2405.04434]

60L d_model=5120 128H (GQA kv=128) d_ff(expert)=1536 vocab=102400,
MoE 160 routed top-6 + 2 shared experts, MLA kv_lora_rank=512.
First layer uses a dense FFN (d_ff=12288) as in the release.  Copy of
``repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=1536,                       # expert hidden size
    vocab=102_400,
    attn="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2,
                  d_ff_expert=1536, d_ff_dense=12288, n_dense_layers=1),
    param_dtype="bfloat16",
    source="arXiv:2405.04434",
))

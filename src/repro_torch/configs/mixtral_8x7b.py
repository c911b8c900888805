"""Mixtral 8x7B — MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, window=4096.  Copy
of ``repro/configs/mixtral_8x7b.py``.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    attn="swa",
    window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    param_dtype="bfloat16",
    source="arXiv:2401.04088",
))

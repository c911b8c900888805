"""Zamba2-7B — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
A single shared-parameter transformer block is applied every 6 mamba
blocks.  Copy of ``repro/configs/zamba2_7b.py``.
"""
from repro_torch.configs.base import (ArchConfig, HybridConfig, SSMConfig,
                                      register)

CONFIG = register(ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_head=64, expand=2, chunk=128),
    hybrid=HybridConfig(attn_every=6, shared_attn=True),
    param_dtype="bfloat16",
    source="arXiv:2411.15242",
))

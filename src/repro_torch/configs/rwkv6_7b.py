"""RWKV-6 "Finch" 7B — attention-free RNN w/ data-dependent decay. [arXiv:2404.05892]

32L d_model=4096 d_ff=14336 vocab=65536. Heads = d_model / 64.  Copy of
``repro/configs/rwkv6_7b.py``.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # rwkv6 heads: d_model / d_head(64)
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    attn="none",
    ssm=SSMConfig(kind="rwkv6", d_head=64, chunk=128, decay_lora=64, mix_lora=32),
    param_dtype="bfloat16",
    source="arXiv:2404.05892",
))

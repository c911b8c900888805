"""Qwen1.5-110B — dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B (arch family)]

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

Copy of ``repro/configs/qwen15_110b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-0.5B",
))

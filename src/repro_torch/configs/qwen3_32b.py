"""Qwen3-32B — dense GQA with qk_norm. [hf:Qwen/Qwen3-8B (arch family)]

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.

Copy of ``repro/configs/qwen3_32b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-8B",
))

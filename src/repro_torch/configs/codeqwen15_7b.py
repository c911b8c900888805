"""CodeQwen1.5-7B — dense, qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B]

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416.

Copy of ``repro/configs/codeqwen15_7b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    param_dtype="bfloat16",
    source="hf:Qwen/CodeQwen1.5-7B",
))

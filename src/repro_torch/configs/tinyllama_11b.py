"""TinyLlama 1.1B — llama2-arch small. [arXiv:2401.02385]

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.  Copy of
``repro/configs/tinyllama_11b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    param_dtype="bfloat16",
    source="arXiv:2401.02385",
))

"""GPT — the paper's own evaluation model family (Megatron GPT).

Copy of ``repro/configs/gpt_paper.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gpt-paper",
    arch_type="dense",
    n_layers=12,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=50304,
    tie_embeddings=True,
    source="TTrace paper §6 (Megatron GPT)",
))

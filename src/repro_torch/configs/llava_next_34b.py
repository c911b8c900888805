"""LLaVA-NeXT 34B — VLM; anyres patch tiles + text. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

Backbone: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
The vision frontend (ViT + projector input) is a stub: the batch carries
precomputed patch embeddings (vision_dim=1024), which the trained projector
maps into d_model and places ahead of the text tokens.

Copy of ``repro/configs/llava_next_34b.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    vision_dim=1024,
    n_image_tokens=2880,      # anyres: 5 tiles x 576 patches
    param_dtype="bfloat16",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))

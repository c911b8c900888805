"""HuBERT X-Large — encoder-only audio transformer. [arXiv:2106.07447]

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means codebook targets).
The conv/mel feature-extractor frontend is a stub: the batch carries
precomputed frame features (audio_dim=512); the model projects them to
d_model and runs the bidirectional encoder with a masked-prediction head.

Copy of ``repro/configs/hubert_xlarge.py``.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,
    audio_dim=512,
    param_dtype="bfloat16",
    source="arXiv:2106.07447",
))

"""Architecture configuration: the dense subset of ``repro/configs/base.py``.

The port carries only the fields the dense decoder path reads; MoE, MLA,
SSM, hybrid and frontend fields arrive with the slices that port those
models.  ``reduced()`` gives the same CPU-smoke variant as the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str              # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # default d_model // n_heads
    source: str = ""            # citation

    # attention flavour
    attn: str = "full"          # full | swa
    window: int = 0             # sliding-window size when attn == "swa"
    rope_theta: float = 10_000.0
    causal: bool = True

    tie_embeddings: bool = False

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant of the same family: 2 layers, d_model<=256."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=d_model // n_heads,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            window=min(self.window, 64) if self.window else 0,
            compute_dtype="float32",
            param_dtype="float32",
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # importing each per-arch module registers it
    from repro_torch.configs import gpt_paper, tinyllama_11b  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None

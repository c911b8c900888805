"""Architecture configuration: the dense and SSM subset of
``repro/configs/base.py``.

The port carries only the fields the dense decoder and RWKV-6 paths read
(``SSMConfig`` is copied whole, mamba2 fields included); MoE, MLA, hybrid
and frontend fields arrive with the slices that port those models.
``reduced()`` gives the same CPU-smoke variant as the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"        # "mamba2" | "rwkv6"
    d_state: int = 64           # mamba2 SSM state size
    d_head: int = 64            # SSM head dim
    expand: int = 2             # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk: int = 128            # chunked-scan block length
    # rwkv6
    decay_lora: int = 64        # rank of the data-dependent decay LoRA (Finch)
    mix_lora: int = 32          # rank of the data-dependent token-shift LoRA


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str              # dense | ssm (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # default d_model // n_heads
    source: str = ""            # citation

    # attention flavour
    attn: str = "full"          # full | swa | none (ssm)
    window: int = 0             # sliding-window size when attn == "swa"
    rope_theta: float = 10_000.0
    causal: bool = True

    tie_embeddings: bool = False

    ssm: Optional[SSMConfig] = None

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
        kw = {}
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, d_head=32, chunk=32, decay_lora=16,
                mix_lora=8)
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
            **kw,
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # importing each per-arch module registers it
    from repro_torch.configs import (  # noqa: F401
        gpt_paper, rwkv6_7b, tinyllama_11b)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None

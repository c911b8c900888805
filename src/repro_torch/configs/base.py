"""Architecture and input-shape configuration: the port of
``repro/configs/base.py``.

``InputShape``, ``INPUT_SHAPES``, ``MoEConfig``, ``MLAConfig``,
``SSMConfig``, ``HybridConfig`` and ``ArchConfig`` are copied whole,
with the reference's defaults.  ``MoEConfig`` adds port-only router
fields after the reference's (``PORT_MOE_FIELDS``: the router's kind,
where ``sigmoid`` is DeepSeek-V3's with its score-correction bias and
sequence-wise balance loss, the routed scaling, and the held share of
the experts); at their defaults a config
routes as the reference does, and the reference's eleven configs keep
them there.  The port keeps its parameters per layer
and never scans, but it reads ``scan_layers`` and ``remat`` as the
reference does: a segment the reference would scan (``scan_layers`` and
more than one layer) runs each block under activation checkpointing when
``remat`` is set (``models/model.Model.apply_blocks``).  ``reduced()``
gives the same CPU-smoke variant as the reference (both switches off),
``supports_shape`` the same verdicts, and ``list_configs`` the reference's
eleven names plus the port-only ``moonlight-16b-a3b``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0          # shared (always-on) experts, deepseek-style
    d_ff_expert: int = 0       # per-expert hidden size
    d_ff_dense: int = 0        # dense FFN hidden for non-MoE layers (deepseek layer 0)
    n_dense_layers: int = 0    # leading layers that use a dense FFN instead of MoE
    router_aux_coef: float = 0.01
    capacity_factor: float = 2.0   # <= 0 means dropless (cap = n_tokens)
    # port-only (PORT_MOE_FIELDS): the router's kind and a held share.
    # softmax is the reference's router; sigmoid is DeepSeek-V3's: f32
    # scores, a score-correction bias that selects and never weighs, and
    # the balance loss per sequence, meaned
    scoring: str = "softmax"
    routed_scaling_factor: float = 1.0   # times the routed weights
    n_held: int = 0                # experts this layer holds (0: all)
    held_offset: int = 0           # the first expert it holds

    @property
    def held(self) -> int:
        """The number of experts a layer holds and computes."""
        return self.n_held or self.n_experts


# MoEConfig's fields the reference's has not; at these defaults a layer
# routes, weighs and computes as the reference's
PORT_MOE_FIELDS = {"scoring": "softmax", "routed_scaling_factor": 1.0,
                   "n_held": 0, "held_offset": 0}


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0       # 0 => full-rank q projection
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


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
class HybridConfig:
    attn_every: int = 6         # apply the shared attention block every N ssm blocks
    shared_attn: bool = True    # single shared-parameter transformer block (zamba2)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # default d_model // n_heads
    source: str = ""            # citation

    # attention flavour
    attn: str = "full"          # full | swa | mla | none (ssm)
    window: int = 0             # sliding-window size when attn == "swa"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True         # False => encoder-only (hubert)

    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # modality frontend stubs
    vision_dim: int = 0         # vlm: incoming patch-embedding feature dim
    n_image_tokens: int = 0     # vlm: patch tokens per sample (anyres tiles flattened)
    audio_dim: int = 0          # audio: incoming frame-feature dim

    # numerics / lowering
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True    # the reference scans stacked layers
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots" (keep matmul outputs)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_decoder(self) -> bool:
        return self.causal and self.arch_type != "audio"

    def supports_shape(self, shape: InputShape) -> tuple[bool, str]:
        """Whether (self, shape) is a live pair; returns (ok, reason-if-skip)."""
        if shape.kind == "decode" and not self.is_decoder:
            return False, "encoder-only architecture has no decode step"
        if shape.name == "long_500k":
            sub_quadratic = (
                self.arch_type in ("ssm", "hybrid")
                or self.attn == "swa"
            )
            if not sub_quadratic:
                return False, "pure full-attention arch; 512k decode needs sub-quadratic attention"
        return True, ""

    def reduced(self) -> "ArchConfig":
        """CPU smoke variant of the same family: 2 layers, d_model<=256,
        <=4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        kw = {}
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=min(self.moe.d_ff_expert, 128),
                d_ff_dense=min(self.moe.d_ff_dense, 256) if self.moe.d_ff_dense else 0,
                n_dense_layers=min(self.moe.n_dense_layers, 1),
                capacity_factor=0.0,   # dropless: exact differential testing
                # the router's kind carries over; the held share does not
                **{k: getattr(self.moe, k) for k in PORT_MOE_FIELDS
                   if k not in ("n_held", "held_offset")},
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                kv_lora_rank=64, q_lora_rank=0, qk_nope_dim=32, qk_rope_dim=16,
                v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, d_head=32, chunk=32, decay_lora=16,
                mix_lora=8)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, attn_every=2)
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
            vision_dim=min(self.vision_dim, 64) if self.vision_dim else 0,
            n_image_tokens=(min(self.n_image_tokens, 16)
                            if self.n_image_tokens else 0),
            audio_dim=min(self.audio_dim, 64) if self.audio_dim else 0,
            scan_layers=False,
            remat=False,
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


def _ensure_loaded():
    # importing each per-arch module registers it
    from repro_torch.configs import (  # noqa: F401
        codeqwen15_7b, deepseek_v2_236b, gpt_paper, hubert_xlarge,
        llava_next_34b, mixtral_8x7b, moonlight_16b_a3b, qwen15_110b,
        qwen3_32b, rwkv6_7b, tinyllama_11b, zamba2_7b)


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)

"""Canonical tensor identifiers and pipeline layer-index mapping (paper
§4.1); copy of ``repro/core/canonical.py``.

A tensor is uniquely identified inside a trace by
``CanonicalId(iteration, microbatch, kind, module, role)``, where
``module`` is the *canonical* module name: local layer indices assigned by
pipeline parallelism (PP) and virtual/interleaved pipeline parallelism
(VPP) are mapped back to the reference model's global layer indices (paper
Fig 5) before naming.  The seed that ``CanonicalId.seed`` derives must
equal the reference's bit for bit: the consistent tensor generator hashes
it, so rewrites match across packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

# trace kinds (paper §4.3)
KIND_ACT = "activation"
KIND_ACT_GRAD = "act_grad"
KIND_PARAM_GRAD = "param_grad"
KIND_MAIN_GRAD = "main_grad"
KIND_PARAM_POST = "param_post_step"


@dataclass(frozen=True, order=True)
class CanonicalId:
    iteration: int
    microbatch: int
    kind: str
    module: str     # canonical module path, e.g. "layers.12.self_attention.linear_qkv"
    role: str       # "input" | "output" | param leaf name | ...

    def __str__(self):
        return (f"it{self.iteration}/mb{self.microbatch}/{self.kind}/"
                f"{self.module}/{self.role}")

    def seed(self) -> int:
        """Stable 63-bit seed for the consistent tensor generator (§4.2)."""
        h = hashlib.blake2b(str(self).encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") & 0x7FFF_FFFF_FFFF_FFFF


def tap_to_id(tap_name: str, kind: str, iteration: int = 0,
              microbatch: int = 0) -> CanonicalId:
    """Split a tap path ``module.path/role`` into a CanonicalId."""
    if "/" in tap_name:
        module, role = tap_name.rsplit("/", 1)
    else:
        module, role = tap_name, "value"
    return CanonicalId(iteration, microbatch, kind, module, role)


# ---------------------------------------------------------------------------
# PP / VPP layer-index mapping (paper Fig 5)
# ---------------------------------------------------------------------------
#
# Megatron interleaved schedule: the model's L layers are cut into
# pp_size * vpp_size contiguous chunks of ``L / (pp*vpp)`` layers.  Chunk
# (vpp_rank, pp_rank) holds global layers starting at
#     vpp_rank * pp_size * cpl  +  pp_rank * cpl
# Each stage numbers its local layers 0..(L/pp - 1) across its vpp chunks.


def chunk_layers(n_layers: int, pp_size: int, vpp_size: int) -> int:
    if n_layers % (pp_size * vpp_size) != 0:
        raise ValueError(
            f"{n_layers} layers not divisible by pp{pp_size} x vpp{vpp_size}")
    return n_layers // (pp_size * vpp_size)


def canonical_layer_index(local_idx: int, pp_rank: int, pp_size: int,
                          vpp_rank: int, vpp_size: int, n_layers: int) -> int:
    """Map a stage-local layer index to the reference (global) layer index.

    ``local_idx`` counts layers *within the (pp_rank, vpp_rank) chunk* —
    Megatron gives each virtual chunk its own offset-free numbering, which is
    exactly the ambiguity the canonical name resolves (paper Fig 5).
    """
    if not (0 <= pp_rank < pp_size and 0 <= vpp_rank < vpp_size):
        raise ValueError("rank out of range")
    cpl = chunk_layers(n_layers, pp_size, vpp_size)
    if not (0 <= local_idx < cpl):
        raise ValueError(f"local layer {local_idx} outside chunk of {cpl}")
    return vpp_rank * pp_size * cpl + pp_rank * cpl + local_idx


def local_layer_index(global_idx: int, pp_size: int, vpp_size: int,
                      n_layers: int) -> tuple[int, int, int]:
    """Inverse of ``canonical_layer_index``: -> (pp_rank, vpp_rank, local_idx)."""
    cpl = chunk_layers(n_layers, pp_size, vpp_size)
    chunk = global_idx // cpl
    vpp_rank, pp_rank = divmod(chunk, pp_size)
    return pp_rank, vpp_rank, global_idx % cpl


def canonicalize_module(module: str, pp_rank: int, pp_size: int,
                        vpp_rank: int = 0, vpp_size: int = 1,
                        n_layers: int | None = None,
                        layer_key: str = "layers.") -> str:
    """Rewrite ``layers.<local>`` inside a module path to the global index."""
    if layer_key not in module or pp_size * vpp_size == 1:
        return module
    pre, rest = module.split(layer_key, 1)
    num, dot, tail = rest.partition(".")
    gidx = canonical_layer_index(int(num), pp_rank, pp_size, vpp_rank,
                                 vpp_size, n_layers)
    return f"{pre}{layer_key}{gidx}{dot}{tail}"

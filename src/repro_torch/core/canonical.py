"""Canonical tensor identifiers (paper §4.1); copy of ``repro/core/canonical.py``.

A tensor is uniquely identified inside a trace by
``CanonicalId(iteration, microbatch, kind, module, role)``.  The seed that
``CanonicalId.seed`` derives must equal the reference's bit for bit: the
consistent tensor generator hashes it, so rewrites match across packages.
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

"""User-written sharding annotations (paper §3 step 2, Fig 2); a copy of
``repro/core/annotations.py``.

The user declares, per parameter and per traced activation, which tensor
dimension each parallel axis shards — e.g.::

    annotations = Annotations.from_dict({
        "params": {
            "embedding.word_embeddings":                {"tp_dim": 0},
            "layers.*.self_attention.linear_qkv.w":     {"tp_dim": 1},
            "layers.*.self_attention.linear_proj.w":    {"tp_dim": 0},
            "layers.*.mlp.gate.w":                      {"tp_dim": 1},
        },
        "acts": {
            "layers.*.self_attention/input":  {"sp_dim": 1, "cp_dim": 1},
            "layers.*.self_attention/output": {"cp_dim": 1},
            "layers.*.mlp/core":              {"tp_dim": -1},
        },
    })

TTrace infers the shard mapping (slices of the logical full tensor owned by
each rank) from these specs + the mesh coordinates — the user never writes
slice arithmetic (paper §4.1).
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Optional

# parallel axes in the order nested splits are applied (outer -> inner).
# cp splits the sequence before sp does: the physical layout is
# cp-major / sp-minor, matching PartitionSpec(("cp", "tp")) on the seq dim.
AXES = ("dp", "ep", "cp", "tp", "sp")


@dataclass(frozen=True)
class ShardSpec:
    tp_dim: Optional[int] = None
    sp_dim: Optional[int] = None
    cp_dim: Optional[int] = None
    dp_dim: Optional[int] = None
    ep_dim: Optional[int] = None
    cp_mode: str = "contiguous"    # "contiguous" | "zigzag" (striped, Fig 6)

    def dim_for(self, axis: str) -> Optional[int]:
        return getattr(self, f"{axis}_dim")

    @property
    def replicated_axes(self) -> tuple[str, ...]:
        return tuple(a for a in AXES if self.dim_for(a) is None)


REPLICATED = ShardSpec()


def _split_range(lo: int, hi: int, n: int, r: int) -> tuple[int, int]:
    size = hi - lo
    if size % n != 0:
        raise ValueError(f"extent {size} not divisible by {n} shards")
    c = size // n
    return lo + r * c, lo + (r + 1) * c


def slices_for_rank(spec: ShardSpec, global_shape: tuple[int, ...],
                    sizes: dict[str, int], coords: dict[str, int]
                    ) -> list[tuple[slice, ...]]:
    """The (possibly non-contiguous) slices of the logical full tensor owned
    by the rank at ``coords``.  Zigzag context parallelism gives each rank two
    stripes (rank r of R owns chunks r and 2R-1-r), hence a *list* of slices.
    """
    ndim = len(global_shape)
    frags: list[list[tuple[int, int]]] = [[(0, s) for s in global_shape]]
    for axis in AXES:
        n = sizes.get(axis, 1)
        dim = spec.dim_for(axis)
        if n == 1 or dim is None:
            continue
        dim = dim % ndim
        r = coords.get(axis, 0)
        new_frags = []
        for fr in frags:
            lo, hi = fr[dim]
            if axis == "cp" and spec.cp_mode == "zigzag":
                for chunk in (r, 2 * n - 1 - r):
                    clo, chi = _split_range(lo, hi, 2 * n, chunk)
                    nf = list(fr)
                    nf[dim] = (clo, chi)
                    new_frags.append(nf)
            else:
                nlo, nhi = _split_range(lo, hi, n, r)
                nf = list(fr)
                nf[dim] = (nlo, nhi)
                new_frags.append(nf)
        frags = new_frags
    return [tuple(slice(lo, hi) for lo, hi in fr) for fr in frags]


def shard_concat_dim(spec: ShardSpec) -> Optional[int]:
    """The dim along which a multi-fragment shard (zigzag cp) concatenates."""
    return spec.cp_dim if spec.cp_mode == "zigzag" else None


@dataclass
class Annotations:
    params: dict[str, ShardSpec] = field(default_factory=dict)
    acts: dict[str, ShardSpec] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "Annotations":
        def conv(section):
            out = {}
            for pat, spec in section.items():
                out[pat] = spec if isinstance(spec, ShardSpec) else ShardSpec(**spec)
            return out
        return cls(params=conv(d.get("params", {})),
                   acts=conv(d.get("acts", {})))

    def _lookup(self, table: dict[str, ShardSpec], name: str) -> ShardSpec:
        if name in table:
            return table[name]
        best = None
        for pat, spec in table.items():
            if fnmatch.fnmatchcase(name, pat):
                if best is None or len(pat) > len(best[0]):
                    best = (pat, spec)
        return best[1] if best else REPLICATED

    def param_spec(self, name: str) -> ShardSpec:
        return self._lookup(self.params, name)

    def act_spec(self, name: str) -> ShardSpec:
        return self._lookup(self.acts, name)

    def spec_for(self, kind: str, name: str) -> ShardSpec:
        from repro_torch.core import canonical as C
        if kind in (C.KIND_ACT, C.KIND_ACT_GRAD):
            return self.act_spec(name)
        return self.param_spec(name)

"""Tensor merger (paper §4.1, §4.4): the shard half of
``repro/core/merger.py``, plus its device-side counterpart.

``merge_shards`` rebuilds a logical full tensor from rank-local numpy
shards and verifies coverage (no overlap, no omission) and replica
consistency (ranks mapping to identical slices must agree), as the
reference does, in float64 on the host.

``assemble_ranks`` / ``split_ranks`` are what the distributed candidate
uses on the card: a **rank-stacked** tensor holds every emulated rank's
shard along dim 0, ranks in ``(dp, cp, tp)`` row-major order
(``rank_coords``).  ``assemble_ranks`` places each shard at the slices
``slices_for_rank`` gives it and reads coordinate 0 of every axis the spec
does not shard, as a ``shard_map`` ``out_specs`` does; it checks no
replica.  ``split_ranks`` is its inverse (``generator.extract_shard`` for
every rank at once).

The per-rank trace path (``canonical_stage_name``,
``merge_microbatch_traces``, ``MergePlan``) arrives with pipeline
parallelism.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.annotations import ShardSpec, slices_for_rank

# relative tolerance for replica agreement: replicas are produced by the SAME
# reduction on each rank, so they should match to ~machine epsilon.
REPLICA_RTOL = 1e-5

# the mesh axes of a rank-stacked tensor, outer to inner
RANK_AXES = ("dp", "cp", "tp")


@dataclass
class MergeReport:
    ok: bool = True
    conflicts: list = field(default_factory=list)   # replica disagreements
    overlap: int = 0
    omission: int = 0
    layout_mismatches: list = field(default_factory=list)
    rank_problems: list = field(default_factory=list)  # per-rank trace merge

    def problems(self) -> list[str]:
        out = []
        if self.overlap:
            out.append(f"{self.overlap} elements covered more than once")
        if self.omission:
            out.append(f"{self.omission} elements not covered by any shard")
        for c in self.conflicts:
            out.append(f"replica conflict at coords {c['coords']} vs "
                       f"{c['ref_coords']}: rel_err={c['rel_err']:.3e}")
        for m in self.layout_mismatches:
            out.append(f"layout mismatch at coords {m['coords']}: annotation "
                       f"says {m['expected']}, array is {m['actual']}")
        out.extend(self.rank_problems)
        return out


def merge_shards(shards: dict[tuple, np.ndarray], spec: ShardSpec,
                 sizes: dict[str, int], global_shape: tuple[int, ...],
                 replica_rtol: float = REPLICA_RTOL
                 ) -> tuple[np.ndarray, MergeReport]:
    """shards: {coords tuple (in AXES order of `sizes` keys) -> local array}.

    ``sizes`` maps axis name -> degree; coords tuples are keyed in the same
    order as ``sizes``.
    """
    axes = list(sizes)
    report = MergeReport()
    full = np.zeros(global_shape, np.float64)
    cover = np.zeros(global_shape, np.int16)
    seen: dict[tuple, tuple] = {}   # frozen slice key -> (coords, array)

    for coords_t, arr in shards.items():
        coords = dict(zip(axes, coords_t))
        frags = slices_for_rank(spec, global_shape, sizes, coords)
        key = tuple((s.start, s.stop) for f in frags for s in f)
        if key in seen:
            ref_coords, ref_arr = seen[key]
            denom = np.linalg.norm(ref_arr.astype(np.float64))
            err = np.linalg.norm(arr.astype(np.float64)
                                 - ref_arr.astype(np.float64))
            rel = err / denom if denom > 0 else err
            if rel > replica_rtol:
                report.conflicts.append(
                    {"coords": coords_t, "ref_coords": ref_coords,
                     "rel_err": float(rel)})
                report.ok = False
            continue
        seen[key] = (coords_t, arr)
        # place fragments: multi-fragment shards are concatenated along the
        # cp dim in chunk order, so walk them in the same order.
        off = 0
        cdim = _concat_dim(spec, len(global_shape))
        for f in frags:
            if cdim is None:
                piece = arr
            else:
                ext = f[cdim].stop - f[cdim].start
                idx = [slice(None)] * arr.ndim
                idx[cdim] = slice(off, off + ext)
                piece = arr[tuple(idx)]
                off += ext
            want = tuple(s.stop - s.start for s in f)
            if piece.shape != want:
                # shard shape contradicts the annotation-derived mapping
                report.layout_mismatches.append(
                    {"coords": coords_t, "expected": want,
                     "actual": piece.shape})
                report.ok = False
                continue
            full[f] += piece.astype(np.float64)
            cover[f] += 1
    report.overlap = int(np.sum(cover > 1))
    report.omission = int(np.sum(cover == 0))
    if report.overlap or report.omission:
        report.ok = False
    return full.astype(np.float32), report


def _concat_dim(spec: ShardSpec, ndim: int):
    if spec.cp_mode == "zigzag" and spec.cp_dim is not None:
        return spec.cp_dim % ndim
    return None


# ---------------------------------------------------------------------------
# Rank-stacked tensors on the device
# ---------------------------------------------------------------------------

def rank_coords(sizes: dict[str, int]) -> list[dict[str, int]]:
    """Every rank's coordinates, in rank-stacked order.  ``sizes`` holds the
    ``dp``/``cp``/``tp`` degrees (and ``sp``, which is the tp group: a rank's
    sp coordinate is its tp coordinate)."""
    dp, cp, tp = (sizes.get(a, 1) for a in RANK_AXES)
    return [{"dp": d, "cp": c, "tp": t, "sp": t}
            for d in range(dp) for c in range(cp) for t in range(tp)]


def sharding_axes(spec: ShardSpec, sizes: dict[str, int]) -> set[str]:
    """The mesh axes whose coordinate selects a different shard of ``spec``
    (sp runs on the tp axis)."""
    used = {a for a in RANK_AXES
            if spec.dim_for(a) is not None and sizes.get(a, 1) > 1}
    if spec.sp_dim is not None and sizes.get("sp", 1) > 1:
        used.add("tp")
    return used


def global_shape(local_shape, spec: ShardSpec, sizes: dict[str, int]) -> tuple:
    """The logical full shape whose shards have ``local_shape``."""
    shape = list(local_shape)
    for ax in ("dp", "cp", "tp", "sp"):
        d = spec.dim_for(ax)
        if d is not None and sizes.get(ax, 1) > 1:
            shape[d % len(shape)] *= sizes[ax]
    return tuple(shape)


def assemble_ranks(stacked: torch.Tensor, spec: ShardSpec,
                   sizes: dict[str, int]) -> torch.Tensor:
    """The logical full tensor of a rank-stacked one, on its device."""
    gshape = global_shape(stacked.shape[1:], spec, sizes)
    used = sharding_axes(spec, sizes)
    cdim = _concat_dim(spec, len(gshape))
    out = stacked.new_empty(gshape)
    for r, coords in enumerate(rank_coords(sizes)):
        if any(coords[a] for a in RANK_AXES if a not in used):
            continue                  # a replica: coordinate 0 stands for it
        off = 0
        for f in slices_for_rank(spec, gshape, sizes, coords):
            piece = stacked[r]
            if cdim is not None:
                ext = f[cdim].stop - f[cdim].start
                piece = piece.narrow(cdim, off, ext)
                off += ext
            out[f] = piece
    return out


def split_ranks(full: torch.Tensor, spec: ShardSpec,
                sizes: dict[str, int]) -> torch.Tensor:
    """Every rank's shard of ``full``, stacked on a new dim 0."""
    cdim = _concat_dim(spec, full.ndim)
    shards = []
    for coords in rank_coords(sizes):
        pieces = [full[f] for f in slices_for_rank(spec, full.shape, sizes,
                                                   coords)]
        shards.append(pieces[0] if len(pieces) == 1
                      else torch.cat(pieces, dim=cdim))
    return torch.stack(shards)

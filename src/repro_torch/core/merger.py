"""Tensor merger (paper §4.1, §4.4): the port of ``repro/core/merger.py``
(its shard half and its per-rank trace half), plus a device-side
counterpart of the shard half.

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

``merge_microbatch_traces`` is the **per-rank trace path** (paper Fig 5):
given the stage-local, per-microbatch traces a pipeline schedule emits, it
concatenates the microbatch axis, canonicalizes stage-local layer names via
the per-stage ``stage_layer_table`` renaming, accumulates per-microbatch
parameter-gradient contributions, and verifies (stage, microbatch)
coverage — no microbatch contributed twice, none missing — before any value
comparison.  ``MergePlan`` is its build-once form for the supervised loop.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import canonical as C
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


# ---------------------------------------------------------------------------
# Per-rank trace merging (pipeline schedules, paper Fig 5)
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^layers\.(\d+)(.*)$")


def canonical_stage_name(name: str, table: list[tuple[int, int]]) -> str:
    """Stage-LOCAL tap/param name -> canonical (global) name via the stage's
    ``(executed, canonical)`` table — the renaming a rank-local trace needs
    before it can align with the single-device reference (paper Fig 5).
    Non-layer names (embedding, final norm, LM head) pass through."""
    m = _LAYER_RE.match(name)
    if not m:
        return name
    local = int(m.group(1))
    if local >= len(table):
        raise KeyError(f"local layer {local} outside a stage table of "
                       f"{len(table)} entries")
    return f"layers.{table[local][1]}{m.group(2)}"


@dataclass
class _Layout:
    """The structure of a per-rank record set, which both merges derive
    the same way: each output leaf with the records it is made of, in the
    full merge's output order, and the coverage verdict."""
    problems: list
    overlap: int
    omission: int
    # [(kind, stage, local name, canonical name, [record index per mb])]
    cat_out: list
    # {canonical name: [(stage, local name, [record index per mb])]}; more
    # than one entry is a replicated (tied) parameter, summed in stage order
    pg_out: dict
    fwd_order: list

    def report(self) -> MergeReport:
        return MergeReport(ok=not self.problems, overlap=self.overlap,
                           omission=self.omission,
                           rank_problems=list(self.problems))


def _layout(records, tables, M: int) -> _Layout:
    """Index ``(stage, mb, Trace)`` records by kind and (stage, name),
    verify (stage, microbatch) coverage and canonical-name uniqueness, and
    lay out the merged trace (the reference's structural walk)."""
    S = len(tables)
    lay = _Layout([], 0, 0, [], {}, [])
    per: dict = {C.KIND_ACT: {}, C.KIND_ACT_GRAD: {}, C.KIND_PARAM_GRAD: {}}
    fwd_orders: dict = {}
    for idx, (stage, mb, tr) in enumerate(records):
        if not (0 <= stage < S and 0 <= mb < M):
            lay.problems.append(f"record (stage {stage}, mb {mb}) outside "
                                f"the {S}x{M} schedule grid")
            continue
        if len(tr.activations) and stage not in fwd_orders:
            fwd_orders[stage] = list(tr.meta.get("fwd_order")
                                     or tr.activations)
        for kind, acc in per.items():
            for name in tr.section(kind):
                by_mb = acc.setdefault((stage, name), {})
                if mb in by_mb:
                    lay.overlap += 1
                    lay.problems.append(f"{kind} {name}: (stage {stage}, mb "
                                        f"{mb}) contributed twice")
                    continue
                by_mb[mb] = idx

    def covered(kind, stage, name, by_mb) -> bool:
        missing = [m for m in range(M) if m not in by_mb]
        if missing:
            lay.omission += len(missing)
            lay.problems.append(f"{kind} {name}: stage {stage} missing "
                                f"microbatch(es) {missing}")
        return not missing

    # activations / activation grads: concat along the microbatch axis
    for kind in (C.KIND_ACT, C.KIND_ACT_GRAD):
        out_names: set = set()
        for stage in sorted({s for s, _ in per[kind]}):
            valid = {name: by_mb for (s, name), by_mb in per[kind].items()
                     if s == stage and covered(kind, stage, name, by_mb)}
            for name, by_mb in valid.items():
                canon = canonical_stage_name(name, tables[stage])
                if canon in out_names:
                    lay.problems.append(f"{kind} {canon}: produced by more "
                                        f"than one stage after canonical "
                                        f"renaming")
                    continue
                out_names.add(canon)
                lay.cat_out.append((kind, stage, name, canon,
                                    [by_mb[m] for m in range(M)]))
    # parameter grads: accumulate the per-microbatch contributions
    for (stage, name) in sorted(per[C.KIND_PARAM_GRAD], key=lambda sn: sn[0]):
        by_mb = per[C.KIND_PARAM_GRAD][(stage, name)]
        if not covered(C.KIND_PARAM_GRAD, stage, name, by_mb):
            continue
        canon = canonical_stage_name(name, tables[stage])
        if canon in lay.pg_out and name.startswith("layers."):
            lay.problems.append(f"param_grad {canon}: produced by more than "
                                f"one stage after canonical renaming")
            continue
        lay.pg_out.setdefault(canon, []).append(
            (stage, name, [by_mb[m] for m in range(M)]))
    lay.fwd_order = [canonical_stage_name(n, tables[stage])
                     for stage in sorted(fwd_orders)
                     for n in fwd_orders[stage]]
    return lay


def _sum_in_order(xs):
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total


def merge_microbatch_traces(records, tables, n_microbatches: int):
    """Merge per-(stage, microbatch) rank-local traces into ONE
    reference-shaped trace.

    ``records``: iterable of ``(stage, microbatch, Trace)`` — forward ops
    contribute ``activations`` (plus per-stage ``meta['fwd_order']``),
    backward ops contribute ``act_grads`` and per-microbatch
    ``param_grads`` contributions.  ``tables``: per-stage
    ``(executed, canonical)`` renaming (``parallel.pp1f1b.stage_tables``).

    The merge verifies per-rank coverage before any value comparison can
    happen: every (stage, name) must be contributed by every microbatch
    exactly once (overlap/omission otherwise), canonicalized names must
    stay unique across stages within a kind — replicated non-layer params
    (tied embeddings on both pipeline ends) instead SUM, the explicit
    tied-embedding reduction — and activations/activation gradients are
    concatenated along the microbatch (batch) axis in microbatch order
    while parameter gradients accumulate across microbatches, left to
    right.

    Returns ``(merged_trace, MergeReport)``; the report also rides along as
    ``merged.meta['merge_report']`` so the checker fails the step on it.
    """
    from repro_torch.core.collector import Trace

    records = list(records)
    lay = _layout(records, tables, n_microbatches)

    def leaf(kind, idx, name):
        return records[idx][2].section(kind).raw(name)

    merged = Trace()
    for kind, _, name, canon, idxs in lay.cat_out:
        merged.section(kind)[canon] = torch.cat(
            [leaf(kind, i, name) for i in idxs], dim=0)
    for canon, group in lay.pg_out.items():
        merged.param_grads[canon] = _sum_in_order(
            [_sum_in_order([leaf(C.KIND_PARAM_GRAD, i, name) for i in idxs])
             for _, name, idxs in group])
    report = lay.report()
    merged.meta["fwd_order"] = list(lay.fwd_order)
    merged.meta["merge_report"] = report
    return merged, report


# ---------------------------------------------------------------------------
# Plan-compiled per-rank merging (the supervised hot path)
# ---------------------------------------------------------------------------
#
# ``merge_microbatch_traces`` re-derives static facts every step: the stage
# tables, the canonical renaming, the coverage grid of a fixed schedule and
# the tied-param groups never change.  ``MergePlan`` lays the structure out
# once on a template record set, then merges every same-structured record
# set with one signature check and one pack per stage (the microbatch
# ``torch.cat`` and the per-microbatch gradient sum, in the same
# left-to-right order), so its output equals the full merge's bit for bit.
# A record set whose structure deviates from the plan falls back to the
# full merge, so structural bugs keep their exact diagnostics.


class MergePlan:
    """Build-once merge plan over a fixed per-rank record structure.

    ``build(records, tables, n_microbatches)`` derives the plan
    from a template record set (typically the first step's); ``execute``
    then merges any same-structured record set.  ``stage_param_grads``
    holds, after ``execute``, the per-stage accumulated parameter gradients
    under their stage-LOCAL names — the 1F1B engine reuses them for the
    executed-index global gradient tree instead of re-accumulating.
    """

    def __init__(self, tables, n_microbatches: int):
        self.tables = tables
        self.M = n_microbatches
        self.signature = None
        self._layout: _Layout | None = None
        # per-stage pack inputs: stage -> [(kind, name, [rec_idx per mb])]
        # and stage -> [(name, [rec_idx per mb])]
        self._stage_cat: dict = {}
        self._stage_pg: dict = {}
        self.stage_param_grads: dict | None = None
        self.executions = 0
        self.fallbacks = 0

    @staticmethod
    def _sig_of(records) -> tuple:
        return tuple((stage, mb, tuple(tr.activations), tuple(tr.act_grads),
                      tuple(tr.param_grads)) for stage, mb, tr in records)

    @classmethod
    def build(cls, records, tables, n_microbatches: int) -> "MergePlan":
        records = list(records)
        plan = cls(tables, n_microbatches)
        plan.signature = cls._sig_of(records)
        plan._layout = lay = _layout(records, tables, n_microbatches)
        for kind, stage, name, _, idxs in lay.cat_out:
            plan._stage_cat.setdefault(stage, []).append((kind, name, idxs))
        for group in lay.pg_out.values():
            for stage, name, idxs in group:
                plan._stage_pg.setdefault(stage, []).append((name, idxs))
        return plan

    @property
    def ok(self) -> bool:
        return not self._layout.problems

    def report(self) -> MergeReport:
        """A fresh MergeReport carrying this structure's (static) verdict."""
        return self._layout.report()

    def matches(self, records) -> bool:
        return self._sig_of(records) == self.signature

    def _pack(self, records, stage):
        """One stage's microbatch concats and gradient sums (left to right,
        as the full merge adds them)."""
        cats = [torch.cat([records[i][2].section(kind).raw(name)
                           for i in idxs], dim=0)
                for kind, name, idxs in self._stage_cat.get(stage, [])]
        pgs = [_sum_in_order([records[i][2].param_grads.raw(name)
                              for i in idxs])
               for name, idxs in self._stage_pg.get(stage, [])]
        return cats, pgs

    def execute(self, records):
        """Merge one record set.  Same-structured sets take the planned
        path; anything else falls back to the full (verifying) merge."""
        from repro_torch.core.collector import Trace

        records = list(records)
        if not self.matches(records):
            self.fallbacks += 1
            self.stage_param_grads = None
            return merge_microbatch_traces(records, self.tables, self.M)
        self.executions += 1
        packed_cat: dict = {}
        packed_pg: dict = {}
        for stage in sorted(set(self._stage_cat) | set(self._stage_pg)):
            cats, pgs = self._pack(records, stage)
            for (kind, name, _), x in zip(self._stage_cat.get(stage, []),
                                          cats):
                packed_cat[(kind, stage, name)] = x
            for (name, _), x in zip(self._stage_pg.get(stage, []), pgs):
                packed_pg[(stage, name)] = x

        lay = self._layout
        merged = Trace()
        for kind, stage, name, canon, _ in lay.cat_out:
            merged.section(kind)[canon] = packed_cat[(kind, stage, name)]
        for canon, group in lay.pg_out.items():
            # the tied-embedding reduction, in stage order
            merged.param_grads[canon] = _sum_in_order(
                [packed_pg[(stage, name)] for stage, name, _ in group])
        self.stage_param_grads = packed_pg
        report = self.report()
        merged.meta["fwd_order"] = list(lay.fwd_order)
        merged.meta["merge_report"] = report
        return merged, report

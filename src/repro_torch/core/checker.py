"""Equivalence checker + diagnosis report (paper §4.4, §3 steps 4-5): the
port of ``repro/core/checker.py``.

Compares a candidate trace against the reference trace under the
estimated thresholds, reports per tensor, and localizes the first
diverging module in forward order (activations) or the deepest diverging
module in backward order (gradients).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core import canonical as C
from repro_torch.core import spans
from repro_torch.core.collector import Trace
from repro_torch.core.generator import generate
from repro_torch.core.relerr_engine import _to_rel_err, section_sq_norms
from repro_torch.core.thresholds import Thresholds

DEFAULT_KINDS = (C.KIND_ACT, C.KIND_ACT_GRAD, C.KIND_PARAM_GRAD,
                 C.KIND_MAIN_GRAD, C.KIND_PARAM_POST)


@dataclass
class CheckRecord:
    kind: str
    name: str
    rel_err: float
    threshold: float
    flagged: bool
    note: str = ""


@dataclass
class Report:
    records: list[CheckRecord] = field(default_factory=list)
    merge_problems: list[str] = field(default_factory=list)
    missing: list[str] = field(default_factory=list)
    localized: Optional[str] = None       # module blamed for the bug
    localization_mode: str = "propagation"  # or "rewrite"

    @property
    def flagged(self) -> list[CheckRecord]:
        return [r for r in self.records if r.flagged]

    @property
    def passed(self) -> bool:
        return not self.flagged and not self.merge_problems

    @property
    def loud(self) -> list[CheckRecord]:
        """Records failing with non-finite rel-err (NaN/Inf poisoning) —
        a LOUD failure, reported separately from threshold exceedances."""
        return [r for r in self.records if "LOUD" in r.note]

    def first_flagged_activation(self) -> Optional[CheckRecord]:
        for r in self.records:            # records kept in forward tap order
            if r.kind == C.KIND_ACT and r.flagged:
                return r
        return None

    def summary(self, max_rows: int = 12) -> str:
        n_flag = len(self.flagged)
        lines = [f"TTrace report: {'PASS' if self.passed else 'FAIL'} "
                 f"({n_flag}/{len(self.records)} tensors flagged, "
                 f"{len(self.merge_problems)} merge problems)"]
        if self.loud:
            lines.append(f"  LOUD: {len(self.loud)} tensors with "
                         f"non-finite rel_err (NaN/Inf poisoning)")
        for p in self.merge_problems:
            lines.append(f"  [merge] {p}")
        shown = 0
        for r in self.records:
            if r.flagged and shown < max_rows:
                lines.append(f"  [{r.kind}] {r.name}: rel_err={r.rel_err:.3e} "
                             f"> thr={r.threshold:.3e} {r.note}")
                shown += 1
        if n_flag > shown:
            lines.append(f"  ... {n_flag - shown} more flagged tensors")
        if self.localized:
            lines.append(f"  LOCALIZED ({self.localization_mode}): bug in "
                         f"module '{self.localized}'")
        return "\n".join(lines)


def _module_of(name: str) -> str:
    return name.rsplit("/", 1)[0] if "/" in name else name


def collect_section_pairs(ref: Trace, cand: Trace, kinds=DEFAULT_KINDS):
    """Pass 1 of a differential check — metadata only, no host transfer.

    Returns ``(entries, leaves_ref, leaves_cand, missing)``: ``entries`` is
    an ordered list of ``(kind, name, note)`` where ``note is None`` marks a
    comparable pair (its leaves appear, in order, in the two leaf lists) and
    a non-None note records a shape mismatch (flagged unconditionally).
    """
    entries: list[tuple[str, str, Optional[str]]] = []
    leaves_ref, leaves_cand, missing = [], [], []
    for kind in kinds:
        rs, cs = ref.section(kind), cand.section(kind)
        for name in rs:
            if name not in cs:
                missing.append(f"{kind}:{name} missing from candidate")
                continue
            sa, sb = rs.shape_of(name), cs.shape_of(name)
            if sa != sb:
                entries.append((kind, name, f"shape {sb} != ref {sa}"))
                continue
            entries.append((kind, name, None))
            leaves_ref.append(rs.raw(name))
            leaves_cand.append(cs.raw(name))
    return entries, leaves_ref, leaves_cand, missing


def merge_problems_of(trace) -> list[str]:
    """The per-rank merge problems a candidate trace carries, if any
    (``trace.meta['merge_report']``); they fail a check on their own."""
    meta = getattr(trace, "meta", None) or {}
    rep = meta.get("merge_report")
    if rep is None or rep.ok:
        return []
    return list(rep.problems())


def report_from_errs(entries, errs, thr: Thresholds, missing=(),
                     thr_scale=1.0, merge_problems=()) -> Report:
    """Pass 2: fold per-pair relative errors (aligned with the comparable
    entries) into a ``Report`` in section order, then localize.

    ``thr_scale`` widens thresholds: a float uniformly, a ``{kind: float}``
    per trace kind (the supervisor's per-step allowance).  ``merge_problems``
    fail the report unconditionally."""
    rep = Report()
    rep.missing.extend(missing)
    rep.merge_problems.extend(merge_problems)
    it = iter(errs)
    for kind, name, mismatch in entries:
        if mismatch is not None:
            rep.records.append(CheckRecord(
                kind, name, float("inf"), 0.0, True, note=mismatch))
            continue
        e = float(next(it))
        scale = (thr_scale.get(kind, 1.0) if isinstance(thr_scale, dict)
                 else thr_scale)
        t = thr.threshold(kind, name) * scale
        if not np.isfinite(e):
            # NaN compares False against every threshold: without this
            # branch a poisoned step would silently PASS
            rep.records.append(CheckRecord(
                kind, name, e, t, True, note="LOUD non-finite rel_err"))
            continue
        rep.records.append(CheckRecord(kind, name, e, t, e > t))
    _localize_propagation(rep)
    return rep


def _localize_propagation(rep: Report) -> None:
    # the first flagged forward activation is the earliest module whose
    # computation diverged (paper §3 step 4)
    first = rep.first_flagged_activation()
    if first is not None:
        rep.localized = _module_of(first.name)
        rep.localization_mode = "propagation"
    elif rep.flagged:
        # backward-only bug: wrong gradients propagate toward the embedding,
        # so the buggy module holds the LAST flagged activation gradient
        agrads = [r for r in rep.records
                  if r.kind == C.KIND_ACT_GRAD and r.flagged]
        pgrads = [r for r in rep.records
                  if r.kind == C.KIND_PARAM_GRAD and r.flagged]
        mgrads = [r for r in rep.records
                  if r.kind == C.KIND_MAIN_GRAD and r.flagged]
        if agrads:
            rep.localized = _module_of(agrads[-1].name)
            rep.localization_mode = "backward"
        elif pgrads:
            # only weight grads wrong: blame the module owning the parameter
            # (norm weights ARE their module)
            name = pgrads[-1].name
            head, _, leaf = name.rpartition(".")
            rep.localized = head if leaf in ("w", "b") else name
            rep.localization_mode = "backward"
        elif mgrads:
            # main grads wrong but raw grads fine: optimizer-side processing
            rep.localized = _module_of(mgrads[0].name)
            rep.localization_mode = "optimizer"
        else:
            # ONLY post-step params flagged: the update itself is wrong
            rep.localized = "optimizer"
            rep.localization_mode = "optimizer"


def compare_traces(ref: Trace, cand: Trace, thr: Thresholds,
                   kinds=DEFAULT_KINDS) -> Report:
    """Differential check of two traces (paper §3 step 4): one metadata pass,
    then ONE batched reduction over every comparable pair of every
    requested section, then threshold comparison + localization.  The
    candidate's per-rank merge problems (``meta['merge_report']``) fail the
    report on their own."""
    entries, la, lb, missing = collect_section_pairs(ref, cand, kinds)
    errs = _to_rel_err(section_sq_norms(la, lb))
    return report_from_errs(entries, errs, thr, missing=missing,
                            merge_problems=merge_problems_of(cand))


def localize_with_rewrites(run_ref, run_cand, batch, ref_trace: Trace,
                           thr: Thresholds, scope_filter=None) -> Report:
    """Rewrite-mode localization (paper §3 step 5): overwrite EVERY module's
    input with a consistent generated tensor in both runs, so an error in
    one module cannot propagate to the next; any module whose OUTPUT still
    diverges is buggy in isolation.

    ``run_ref/run_cand(batch, rewrites) -> Trace``.
    """
    rewrites = {}
    with spans.span("rewrites"):
        for name in ref_trace.activations:
            if not name.endswith("/input"):
                continue
            if scope_filter is not None and not scope_filter(name):
                continue
            a = ref_trace.activations[name]     # host copy of module inputs
            cid = C.tap_to_id(name, C.KIND_ACT)
            scale = float(np.std(a)) or 1.0
            rewrites[name] = generate(cid, a.shape, str(a.dtype), scale=scale)
    with spans.span("run"):
        t_ref = run_ref(batch, rewrites)
    with spans.span("run"):
        t_cand = run_cand(batch, rewrites)
    rep = compare_traces(t_ref, t_cand, thr, kinds=(C.KIND_ACT,))
    # under rewrites every flagged *output* names its buggy module directly;
    # report the FIRST one in forward execution order
    order = t_ref.meta.get("fwd_order") or [r.name for r in rep.records]
    rank = {n: i for i, n in enumerate(order)}
    flagged_mods = [(rank.get(r.name, 1 << 30), _module_of(r.name))
                    for r in rep.records
                    if r.flagged and r.name.endswith("/output")]
    # no module diverging in isolation means the bug lives in the glue
    # between modules; the propagation report keeps the verdict then
    rep.localized = min(flagged_mods)[1] if flagged_mods else None
    rep.localization_mode = "rewrite"
    return rep

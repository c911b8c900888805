"""The comparison that decides ``correct``.

``program_readings`` reads what one ``ttrace_check`` produced: for its
reference trace and its candidate trace, the loss and the float64 norm of
every leaf of every section (a post-step parameter as its change from the
benchmark's weights); the threshold of every record; and each record's
rel-err and verdict beside the rel-err worked out again in float64 from
the same two traces.  ``reference_readings`` gives the same shape from
the plain reference's ``common.readings`` (both sides alike), which is
also how the float8 control stands in the program's place.

``numbers`` holds the two against each other:

* ``loss``: the largest ``|L - L_ref| / |L_ref|`` of the two sides;
* ``grads``, ``update``, ``acts``: over the gradients and main gradients,
  the parameter changes, and the activations and their gradients, the
  largest ``| ||x|| - ||x_ref|| | / max(||x_ref||, median leaf's)`` of
  the two sides; a parameter whose reference gradient is under a
  thousandth of the median leaf's (a key bias under softmax) is left out;
* ``thresholds``: over each section, the median ratio, either way round,
  of the program's threshold of a tensor to the reference's; the largest
  of these (``thresholds_max``: the largest ratio of any tensor);
* ``relerr``: the largest ``|rel_err - rel_err64| / threshold`` of a
  record;
* ``verdicts``: the records whose verdict differs from ``rel_err64 >
  threshold``, plus the clean checks that did not pass;
* ``worst_ratio`` (compared with nothing, reported): the largest
  ``rel_err / threshold`` of a record, the clean check's margin.
"""
from __future__ import annotations

import math
import statistics

from port_bench.reference import common
from port_bench.reference.common import (ACT, ACT_GRAD, MAIN_GRAD, PARAM_GRAD,
                                         PARAM_POST, SECTIONS)

SIDES = ("reference", "candidate")
MISSING = 1e300      # what a missing or non-finite reading counts as
TINY_GRAD = 1e-3

_FIELDS = {ACT: "activations", ACT_GRAD: "act_grads",
           PARAM_GRAD: "param_grads", MAIN_GRAD: "main_grads",
           PARAM_POST: "params_post"}


def _side(trace, initial: dict) -> dict:
    norms = {}
    for kind in SECTIONS:
        sec = getattr(trace, _FIELDS[kind])
        if kind == PARAM_POST:
            norms[kind] = {k: common.norm64(x.float() - initial[k].float())
                           for k, x in sec.raw_items()}
        else:
            norms[kind] = {k: common.norm64(x) for k, x in sec.raw_items()}
    return {"loss": float(trace.loss), "norms": norms}


def program_readings(res, initial: dict) -> dict:
    """What the comparison reads of a ``TTraceResult`` (see the module
    docstring); ``initial``: the weights the check started from."""
    out = {side: _side(getattr(res, side), initial) for side in SIDES}
    out["thresholds"] = {kind: {k: res.thresholds.threshold(kind, k)
                                for k in out["reference"]["norms"][kind]}
                         for kind in SECTIONS}
    ref, cand = res.reference, res.candidate
    out["records"] = [
        (r.kind, r.name, float(r.rel_err), float(r.threshold), bool(r.flagged),
         common.rel_err64(getattr(ref, _FIELDS[r.kind]).raw(r.name),
                          getattr(cand, _FIELDS[r.kind]).raw(r.name)))
        for r in res.report.records if not r.note]
    out["noted"] = [f"{r.kind}:{r.name}: {r.note}" for r in res.report.records
                    if r.note]
    out["passed"] = bool(res.passed)
    out["sizes"] = {kind: [int(x.numel()) for _, x in
                           getattr(ref, _FIELDS[kind]).raw_items()]
                    for kind in SECTIONS}
    return out


def reference_readings(r: dict) -> dict:
    """``common.readings``' result in ``program_readings``' shape, both
    sides alike and no records: how the control stands in for the
    program."""
    side = {"loss": r["loss"], "norms": r["norms"]}
    return {"reference": side, "candidate": side,
            "thresholds": r["thresholds"]}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else MISSING


def _gap(prog: dict, ref: dict, names, where=None, key=None) -> float:
    """The largest gap of norms over ``names`` (see the module docstring);
    a name missing from the program reads 1.  ``where[key]`` records the
    name of the worst leaf when it is the largest so far."""
    if not names:
        return 0.0
    med = statistics.median(ref[k] for k in names)
    worst, at = 0.0, None
    for k in names:
        g = (1.0 if k not in prog
             else _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)))
        if g > worst:
            worst, at = g, k
    if where is not None and worst >= where.get(key, (0.0, None))[0]:
        where[key] = (worst, at)
    return worst


def numbers(prog: dict, ref: dict, false_alarms: int = 0,
            where: dict | None = None) -> dict:
    """The numbers compared (see the module docstring): ``prog`` from
    ``program_readings`` (or ``reference_readings`` for the control),
    ``ref`` from ``common.readings`` in float32; ``where``, if given,
    gets the worst leaf of each gap."""
    rn = ref["norms"]
    med = statistics.median(rn[PARAM_GRAD].values())
    params = [k for k, n in rn[PARAM_GRAD].items() if n >= TINY_GRAD * med]
    taps = list(rn[ACT])
    out = {"loss": 0.0, "grads": 0.0, "update": 0.0, "acts": 0.0}
    for side in SIDES:
        p, pn = prog[side], prog[side]["norms"]
        out["loss"] = max(out["loss"], _finite(
            abs(p["loss"] - ref["loss"]) / abs(ref["loss"])))
        out["grads"] = max(
            out["grads"],
            _gap(pn[PARAM_GRAD], rn[PARAM_GRAD], params, where, "grads"),
            _gap(pn[MAIN_GRAD], rn[MAIN_GRAD], params, where, "grads"))
        out["update"] = max(out["update"], _gap(
            pn[PARAM_POST], rn[PARAM_POST], params, where, "update"))
        out["acts"] = max(out["acts"],
                          _gap(pn[ACT], rn[ACT], taps, where, "acts"),
                          _gap(pn[ACT_GRAD], rn[ACT_GRAD], taps, where,
                               "acts"))
    medians, worst = [], 1.0
    for kind in SECTIONS:
        names = taps if kind in (ACT, ACT_GRAD) else params
        ratios = []
        for k in names:
            tp = prog["thresholds"][kind].get(k)
            tr = ref["thresholds"][kind][k]
            ratios.append(MISSING if not tp or not math.isfinite(tp)
                          else max(tp / tr, tr / tp))
        if ratios:
            medians.append(statistics.median(ratios))
            worst = max(worst, max(ratios))
    out["thresholds"] = max(medians, default=1.0)
    out["thresholds_max"] = worst
    if "records" in prog:
        recs = prog["records"]
        out["relerr"] = max((_finite(abs(r - r64) / thr)
                             for _, _, r, thr, _, r64 in recs), default=0.0)
        wrong = sum(flag != (r64 > thr) for _, _, _, thr, flag, r64 in recs)
        out["verdicts"] = (wrong + len(prog["noted"]) + false_alarms
                           + (not prog["passed"]))
        out["worst_ratio"] = max((r / thr for _, _, r, thr, _, _ in recs),
                                 default=0.0)
    return out


def judge(nums: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, lines)``: every number that has a limit at or under
    it, and one line per number compared."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = nums.get(name)
        good = v is not None and v <= limit
        ok &= good
        lines.append(f"{name} {v!r} limit {limit!r}"
                     + ("" if good else " FAILED"))
    return ok, lines

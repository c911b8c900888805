"""Double-buffered async checking for the streaming supervisor: the port
of ``repro/supervise/pipeline.py``.

Synchronous per-step checking (``compare_traces`` on the training loop)
serializes: dispatch the reduction, BLOCK for the ``(N, 2)`` scalars, build
the report, only then dispatch step k+1 — host and device take turns idling.
This pipeline splits the check into the two passes the checker already
exposes:

* at ``submit(k)`` the metadata pass runs (no transfer) and the whole-trace
  pair reduction is dispatched on device (``relerr_engine.sq_norms_async``) —
  the returned ``NormsFuture`` (a CUDA event behind a pinned host copy) is
  held;
* resolution (host transfer of N x 2 scalars + threshold comparison +
  localization) happens when the entry leaves the bounded in-flight window,
  by which time step k+1's compute has been dispatched behind it.

The window is the backpressure bound: at most ``window`` step reductions
(and the trace leaves they reference) are in flight; submitting beyond it
resolves the oldest entry first, so device memory for pending checks stays
O(window), never O(run length).

Thresholds are estimated at step 0 (paper §5) and — when the supervisor's
periodic re-estimation is on — refreshed every R steps from the live batch
and swapped in as a new *threshold epoch* (``swap_thresholds``).  Each
check resolves against the epoch active at its OWN step, so late async
resolutions and bisection replays see the schedule the step trained under.
Multi-step checking needs two allowances on top of the estimates:

* per-step kinds (activations / gradients) see batch-to-batch variation of
  the true FP-noise level that a single-batch estimate misses — measured at
  up to ~8x on clean runs — so they get a constant widening
  (``SUPERVISED_KIND_MULT``, bug errors sit ~100-1000x above thresholds).
  With re-estimation the estimates track the live noise level (and only
  ever widen, ``Thresholds.union``), so the widening tightens to
  ``REESTIMATED_KIND_MULT`` — back toward the paper's single-step 8x;
* both sides accumulate independent round-off as states evolve, so every
  threshold additionally grows by ``1 + drift_alpha * step`` (anchored at
  step 0: accumulated ref/cand divergence never resets, re-estimation or
  not).

``param_post_step`` keeps multiplier 1.0: the post-step parameter comparison
is cumulative state, empirically flat on clean runs (~0.1x threshold), and
it is exactly the signal that catches slow update-path drift — widening it
would blind the supervisor to the bugs it exists for.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import canonical as C
from repro_torch.core.checker import (DEFAULT_KINDS, Report,
                                      collect_section_pairs,
                                      merge_problems_of, report_from_errs)
from repro_torch.core.relerr_engine import _to_rel_err, sq_norms_async
from repro_torch.core.thresholds import Thresholds
from repro_torch.supervise.watchdog import CheckTimeout, Watchdog

SUPERVISED_KIND_MULT = {
    C.KIND_ACT: 8.0,
    C.KIND_ACT_GRAD: 8.0,
    C.KIND_PARAM_GRAD: 16.0,
    C.KIND_MAIN_GRAD: 16.0,
    C.KIND_PARAM_POST: 1.0,
}

# margins under periodic re-estimation: the live union-of-estimates absorbs
# most batch-to-batch variation, so the constant widening tightens (4-8x vs
# 8-16x) back toward the paper's single-step margin
REESTIMATED_KIND_MULT = {
    C.KIND_ACT: 4.0,
    C.KIND_ACT_GRAD: 4.0,
    C.KIND_PARAM_GRAD: 8.0,
    C.KIND_MAIN_GRAD: 8.0,
    C.KIND_PARAM_POST: 1.0,
}


@dataclass
class StepCheck:
    """One resolved online check: the step index and its report."""
    step: int
    report: Report

    @property
    def flagged(self) -> bool:
        return not self.report.passed


class AsyncCheckPipeline:
    """Bounded-window async differential checking over a supervised run."""

    def __init__(self, thresholds: Thresholds, window: int = 2,
                 kinds=DEFAULT_KINDS, kind_mult=None,
                 drift_alpha: float = 0.125, kind_scale: float = 1.0):
        self.window = max(0, int(window))
        self.kinds = kinds
        self.drift_alpha = drift_alpha
        # recipe-supplied widening of the per-step kind margins: candidates
        # whose numerics legitimately reassociate more than the reference
        # (1F1B microbatch grad accumulation sums M partial reductions)
        # declare their allowance here.  param_post_step is exempt — it is
        # the slow-drift signal and stays at multiplier 1.0.
        self.kind_scale = float(kind_scale)
        # threshold epochs: (from_step, thresholds, kind_mult), sorted; a
        # step's check uses the last epoch with from_step <= step
        self._epochs: list[tuple[int, Thresholds, dict]] = [
            (0, thresholds, dict(SUPERVISED_KIND_MULT if kind_mult is None
                                 else kind_mult))]
        # pending epochs whose estimate is still a device future:
        # (from_step, resolve() -> Thresholds, kind_mult), settled lazily —
        # a check of step >= from_step forces resolution first, so results
        # are bit-identical to resolving at submission
        self._pending_epochs: list[tuple[int, Any, dict]] = []
        self.epochs_settled = 0
        self._inflight: deque = deque()
        self._clock = 0            # monotone submit/poll tick counter
        self.submitted = 0
        self.resolved = 0
        self.max_in_flight = 0
        # fault-tolerance hooks, all wired by the supervisor:
        #: watchdog ladder around the resolution transfer (None = block)
        self.watchdog: Optional[Watchdog] = None
        #: sync recompute of a timed-out check from retained traces;
        #: raises KeyError when the evidence is gone
        self.fallback: Optional[Callable[[int], "StepCheck"]] = None
        #: journal callback for every settled threshold epoch
        self.on_epoch: Optional[Callable[[int, Thresholds, dict],
                                         None]] = None
        #: fault-injection tap on the submitted device future
        self.tap_future: Optional[Callable[[int, Any], Any]] = None
        self.rescued = 0
        self.lost = 0

    # ---- threshold schedule ------------------------------------------------
    @property
    def thresholds(self) -> Thresholds:
        return self._epochs[-1][1]

    @property
    def kind_mult(self) -> dict:
        return self._epochs[-1][2]

    def swap_thresholds(self, thr: Thresholds, step: int,
                        kind_mult=None) -> None:
        """Install re-estimated thresholds for checks at steps >= ``step``.

        In-flight entries from earlier steps keep resolving against their
        own epoch, and bisection replays of earlier steps see the schedule
        those steps originally trained under."""
        km = dict(self.kind_mult if kind_mult is None else kind_mult)
        self._epochs.append((step, thr, km))
        self._epochs.sort(key=lambda e: e[0])

    def schedule_epoch(self, step: int, resolve, kind_mult=None) -> None:
        """Register a threshold epoch whose estimate is still in flight.

        ``resolve() -> Thresholds`` is the estimate's resolution (host
        transfer of the reduction scalars).  The epoch is settled — resolved,
        union-merged onto the running thresholds, installed for checks at
        steps >= ``step`` — lazily: either when a check at such a step needs
        it (determinism: the check sees exactly the epoch it would have seen
        under synchronous estimation) or at ``drain()``.  Until then the
        estimate overlaps training compute instead of stalling the loop."""
        km = dict(self.kind_mult if kind_mult is None else kind_mult)
        self._pending_epochs.append((int(step), resolve, km))
        self._pending_epochs.sort(key=lambda e: e[0])

    def settle_epochs(self, step=None) -> int:
        """Resolve pending epochs with ``from_step <= step`` (all of them
        when ``step`` is None), in submission order."""
        n = 0
        while self._pending_epochs and (
                step is None or self._pending_epochs[0][0] <= step):
            s, resolve, km = self._pending_epochs.pop(0)
            merged = self.thresholds.union(resolve())
            self._epochs.append((s, merged, km))
            self._epochs.sort(key=lambda e: e[0])
            self.epochs_settled += 1
            if self.on_epoch is not None:
                # a settled epoch is a durable fact: a resume must replay
                # it (a pending estimate dies with the process and only
                # re-running its step reproduces it)
                self.on_epoch(s, merged, km)
            n += 1
        return n

    def _epoch_for(self, step: int) -> tuple[int, Thresholds, dict]:
        self.settle_epochs(step)
        ep = self._epochs[0]
        for e in self._epochs:
            if e[0] <= step:
                ep = e
            else:
                break
        return ep

    def thresholds_for(self, step: int) -> Thresholds:
        return self._epoch_for(step)[1]

    def scales(self, step: int) -> dict:
        """Per-kind threshold scale at ``step``.  Step 0 compares identical
        states on the estimation batch — exact single-step semantics, except
        the recipe's ``kind_scale``: a candidate's own reassociation (1F1B
        microbatch accumulation) is present from the very first step."""
        def recipe(k):
            return self.kind_scale if k != C.KIND_PARAM_POST else 1.0
        if step == 0:
            return {k: recipe(k) for k in self.kinds}
        mult = self._epoch_for(step)[2]
        growth = 1.0 + self.drift_alpha * step
        return {k: mult.get(k, 1.0) * growth * recipe(k)
                for k in self.kinds}

    def param_post_threshold(self, name: str, step: int) -> float:
        """Post-step parameter threshold at ``step`` — the bisection
        probe's schedule (shared with the online checks)."""
        thr = self.thresholds_for(step)
        scale = self.scales(step).get(C.KIND_PARAM_POST, 1.0)
        return thr.threshold(C.KIND_PARAM_POST, name) * scale

    # ---- pipeline ----------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    @property
    def saturated(self) -> bool:
        """True when the in-flight window is full AND its oldest entry is
        not ready — the next submit will BLOCK on a slow/hung resolution.
        The degradation controller's stall signal."""
        if self.window == 0 or len(self._inflight) < self.window:
            return False
        ready = getattr(self._inflight[0][4], "is_ready", None)
        return ready is not None and not ready()

    def submit(self, step: int, ref, cand) -> list[StepCheck]:
        """Enqueue the step-``step`` check; returns any checks that the
        backpressure bound forced to resolve (oldest first)."""
        entries, la, lb, missing = collect_section_pairs(ref, cand,
                                                         self.kinds)
        dev = sq_norms_async(la, lb)
        if self.tap_future is not None:
            dev = self.tap_future(step, dev)
        self._clock += 1
        self._inflight.append((step, entries, missing,
                               merge_problems_of(cand), dev, self._clock))
        self.submitted += 1
        done = []
        while len(self._inflight) > self.window:
            done.append(self._resolve())
        self.max_in_flight = max(self.max_in_flight, len(self._inflight))
        return done

    def poll(self) -> list[StepCheck]:
        """Resolve entries whose device reduction already finished — free
        progress on steps where nothing was submitted.  When the future
        exposes no ``is_ready`` (a plain array), fall back to resolving
        entries older than the window in pipeline ticks, so the pipeline
        still drains instead of deferring everything to ``drain()``."""
        self._clock += 1
        # settle pending threshold epochs whose device reduction already
        # finished (in order — an unready head blocks later epochs so the
        # union sequence stays the synchronous one)
        while self._pending_epochs and getattr(
                self._pending_epochs[0][1], "ready", lambda: False)():
            self.settle_epochs(self._pending_epochs[0][0])
        done = []
        while self._inflight:
            dev, born = self._inflight[0][4], self._inflight[0][5]
            ready = getattr(dev, "is_ready", None)
            if ready is not None:
                if not ready():
                    break
            elif self._clock - born <= self.window:
                break              # age fallback: not old enough yet
            done.append(self._resolve())
        return done

    def drain(self) -> list[StepCheck]:
        """Resolve everything still in flight (end of run), pending
        threshold epochs included."""
        done = []
        while self._inflight:
            done.append(self._resolve())
        self.settle_epochs()
        return done

    def check_sync(self, step: int, ref, cand) -> StepCheck:
        """Synchronous one-step check with the supervised threshold schedule
        (the bisection replay path, and the ``--async-window 0`` mode)."""
        entries, la, lb, missing = collect_section_pairs(ref, cand,
                                                         self.kinds)
        errs = _to_rel_err(np.asarray(sq_norms_async(la, lb), np.float64))
        rep = report_from_errs(entries, errs, self.thresholds_for(step),
                               missing=missing, thr_scale=self.scales(step),
                               merge_problems=merge_problems_of(cand))
        return StepCheck(step, rep)

    def _resolve(self) -> StepCheck:
        step, entries, missing, merge_problems, dev, _ = \
            self._inflight.popleft()
        try:
            if self.watchdog is not None:
                arr = self.watchdog.wait(
                    lambda: np.asarray(dev, np.float64),
                    "check transfer", step)
            else:
                arr = np.asarray(dev, np.float64)
        except CheckTimeout as e:
            self.resolved += 1
            return self._rescue(step, str(e))
        errs = _to_rel_err(arr)
        rep = report_from_errs(entries, errs, self.thresholds_for(step),
                               missing=missing, thr_scale=self.scales(step),
                               merge_problems=merge_problems)
        self.resolved += 1
        return StepCheck(step, rep)

    def _rescue(self, step: int, why: str) -> StepCheck:
        """Escalation past the watchdog ladder: recompute the check
        synchronously from retained host traces (``fallback``, wired to the
        supervisor's trace ring).  Evidence gone too -> the check is LOST —
        reported loudly in the step's record, run keeps progressing."""
        if self.fallback is not None:
            try:
                chk = self.fallback(step)
                self.rescued += 1
                if self.watchdog is not None:
                    self.watchdog.event("sync_fallback", step,
                                        "recomputed from trace ring")
                return chk
            except KeyError as e:
                why = f"{why}; fallback: {e}"
        self.lost += 1
        if self.watchdog is not None:
            self.watchdog.event("check_lost", step, why)
        rep = Report(missing=[f"check lost at step {step}: {why}"])
        return StepCheck(step, rep)

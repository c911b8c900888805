"""Multi-step supervisor: online TTrace over a whole training run; the
port of ``repro/supervise/runner.py``.

``Supervisor`` threads (params, opt_state) through BOTH the single-device
reference and the distributed candidate for N steps, using one step
builder per side (``collector.make_trace_step`` / the recipe's
``CandidateStep``), and checks every step online through the async
pipeline.  With ``overlap=True`` (the default) every non-training cost
rides off the critical path: spill and checkpoint writes run on
background threads from host copies the loop takes without waiting, and
threshold re-estimation resolves like an async check — all bit-identical
to the lockstep path (``overlap=False``), which exists for A/B timing and
the determinism tests.  One card has no spare device for the reference
step (the reference's ``spare_host_device``): both steps are dispatched
back to back on one stream, and the loop waits for the device only where
the pipeline consumes a check's N x 2 scalars (once, at step 2, it waits
to start the steady-state clock):

    step k trains  ->  step-k reductions enqueue on device  ->  step k+1
    trains while step k's N x 2 scalars are still in flight  ->  the
    bounded window resolves step k's report

The candidate side is RECIPE-GENERIC: ``CandidateStep`` is the contract —
a stateful train step plus a runner factory for rewrite-mode localization
and the recipe's machine epsilon — and ``CandidateStep.build`` dispatches
on the ``ParallelConfig`` to the distributed candidate (dense / MoE /
ZeRO-1), the staged or 1F1B pipeline (``parallel.pp``,
``parallel.pp1f1b``), or the FP8 recipes (``precision.fp8``, checked
under BF16 epsilon per paper §6.7).

With ``reestimate_every=R`` the supervised loop additionally re-runs the
fused pair-step threshold estimate on the live batch every R steps and
swaps the (union-merged) thresholds into the async pipeline — margins then
tighten from the coarse ``SUPERVISED_KIND_MULT`` constants to
``REESTIMATED_KIND_MULT``, back toward the paper's single-step 8x.

On a flag the run is bisected to the FIRST bad step (checkpoint binary
search + deterministic sync replay, ``supervise.bisect``) and that step is
handed to the paper's localization machinery — propagation/backward/
optimizer modes from the step report, plus rewrite-mode module isolation
when the divergence is in the forward pass.  This is the paper's §3
workflow (steps 1-5) run as a loop over the whole training run instead of
a single snapshot.
"""
from __future__ import annotations

import math
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import ChecksumError
from repro_torch.core.checker import Report, localize_with_rewrites
from repro_torch.core.collector import (load_params, make_trace_step,
                                        named_params)
from repro_torch.core.harness import inputs_on, make_model_runner
from repro_torch.core.relerr_engine import batched_rel_err
from repro_torch.core.thresholds import (MACHINE_EPS, Thresholds,
                                         estimate_thresholds,
                                         make_pair_estimator)
from repro_torch.data.synthetic import make_batch
from repro_torch.parallel.api import (ParallelConfig, make_candidate_runner,
                                      make_candidate_train_step)
from repro_torch.supervise.bisect import (BisectResult, CheckpointKeeper,
                                          bisect_first_bad)
from repro_torch.supervise.faults import FaultInjector
from repro_torch.supervise.journal import (Journal, JournalState,
                                           journal_path, report_to_payload,
                                           thresholds_to_payload)
from repro_torch.supervise.pipeline import (REESTIMATED_KIND_MULT,
                                            AsyncCheckPipeline, StepCheck)
from repro_torch.supervise.store import TraceRing
from repro_torch.supervise.watchdog import (DegradationController, Watchdog,
                                            WatchdogEvent)


@dataclass
class CandidateStep:
    """The recipe-generic candidate contract the supervisor drives.

    ``step(params, opt_state, batch) -> (Trace, new_params, new_opt_state)``
    is a stateful train step (the same callable every supervised step and
    bisection replay) that updates nothing in place; ``make_runner(params,
    opt_state)`` builds the one-shot ``runner(batch, rewrites) -> Trace``
    used for rewrite-mode localization at the first bad step; ``eps`` is
    the machine epsilon threshold estimation should use for this recipe
    (BF16's for FP8 recipes, paper §6.7, and for a bf16-compute model).
    """
    step: Callable
    params0: Any
    opt_state0: Any
    make_runner: Callable
    eps: float = MACHINE_EPS["float32"]
    name: str = "candidate"
    # widening of the supervised per-step kind margins this recipe's
    # numerics need on top of the reference estimate (param_post exempt):
    # the 1F1B engine accumulates M per-microbatch partial reductions, a
    # reassociation the single-batch estimate cannot see
    kind_scale: float = 1.0

    @classmethod
    def build(cls, cfg, pcfg: ParallelConfig, params, opt,
              device="cuda") -> "CandidateStep":
        """Dispatch on ``pcfg`` (distributed / pp / 1F1B / fp8) via
        ``parallel.api``.  The recipe's epsilon is widened to the model's
        compute dtype: a perturbation at f32 epsilon vanishes in a bf16
        activation, and its estimate would be the floor."""
        step, p0, s0 = make_candidate_train_step(cfg, pcfg, params, opt,
                                                 device=device)
        eps = max(MACHINE_EPS["float8_e4m3fn"] if pcfg.fp8
                  else MACHINE_EPS["float32"],
                  MACHINE_EPS[cfg.compute_dtype])
        kind_scale = 1.0
        if pcfg.recipe_kind == "pp_1f1b":
            name = f"pp1f1b{pcfg.pp}x{pcfg.microbatches}"
            kind_scale = max(2.0, math.sqrt(pcfg.microbatches))
        elif pcfg.fp8:
            name = "fp8-" + pcfg.fp8
        elif pcfg.pp > 1:
            name = f"pp{pcfg.pp}"
        else:
            name = "shard_map"
        return cls(
            step=step, params0=p0, opt_state0=s0,
            make_runner=lambda p, s: make_candidate_runner(
                cfg, pcfg, p, opt, s, device=device),
            eps=eps, name=name, kind_scale=kind_scale)


@dataclass
class SuperviseConfig:
    steps: int = 8
    check_every: int = 1        # online check every C-th step; 0 = never
    async_window: int = 2       # in-flight device checks; 0 = synchronous
    # overlap everything off the training critical path: background spill
    # and checkpoint writes, threshold re-estimation resolved like an async
    # check.  False = the lockstep path (same results bit-for-bit; the
    # determinism tests pin that)
    overlap: bool = True
    ckpt_every: int = 4         # periodic bisection checkpoints
    ckpt_keep: int = 16         # checkpoint count bound (log-spaced thinning)
    ring_window: int = 4        # live trace pairs kept in memory
    spill: bool = True          # spill evicted trace pairs to disk
    spill_keep: int = 8         # unpinned spilled steps retained on disk
    drift_alpha: float = 0.125  # per-step threshold growth allowance
    reestimate_every: int = 0   # re-run the fused pair estimate every R steps
    eps: Optional[float] = None  # None = auto (recipe eps; BF16 for FP8
    #                              and for a bf16-compute model)
    margin: float = 8.0
    localize: bool = True       # rewrite-mode localization at the bad step
    stop_on_flag: bool = True   # end the run once a resolved check flags
    work_dir: Optional[str] = None   # checkpoints + spill (tmp if None)
    seed: int = 0
    # ---- fault tolerance ---------------------------------------------------
    journal: bool = True        # fsync'd per-step journal (resume support)
    watchdog_timeout_s: float = 60.0  # per-wait budget on check transfers
    watchdog_retries: int = 1   # retries before sync-fallback escalation
    degrade_after: int = 3      # consecutive saturated checks before sampling
    degrade_max_mult: int = 8   # cap on the effective check_every multiplier


@dataclass
class SuperviseResult:
    flagged: bool
    steps_run: int
    first_flagged_step: Optional[int]   # first ONLINE-checked step flagging
    first_bad_step: Optional[int]       # after bisection refinement
    checks: dict = field(default_factory=dict)   # step -> Report (resolved)
    bad_check: Optional[StepCheck] = None
    bisection: Optional[BisectResult] = None
    localization: Optional[Report] = None        # rewrite-mode report
    thresholds: Optional[Thresholds] = None
    reestimations: int = 0              # threshold epochs swapped in
    losses: list = field(default_factory=list)          # reference loss/step
    cand_losses: list = field(default_factory=list)
    timings: dict = field(default_factory=dict)
    work_dir: Optional[str] = None
    # ---- fault tolerance ---------------------------------------------------
    resumed_from: Optional[int] = None  # journaled-resume entry step
    loud_steps: list = field(default_factory=list)  # NaN/Inf-poisoned steps
    degradations: list = field(default_factory=list)  # degrade/recover events
    watchdog_events: list = field(default_factory=list)
    checks_rescued: int = 0     # timed-out checks recomputed synchronously
    checks_lost: int = 0        # timed-out checks whose evidence was gone
    degraded_check_every: Optional[int] = None  # final effective cadence

    @property
    def passed(self) -> bool:
        return not self.flagged

    @property
    def localized_module(self) -> Optional[str]:
        if self.localization is not None and self.localization.localized:
            return self.localization.localized
        if self.bad_check is not None and self.bad_check.report is not None:
            return self.bad_check.report.localized
        if self.first_flagged_step is not None:
            return self.checks[self.first_flagged_step].localized
        return None

    def summary(self, max_rows: int = 8) -> str:
        lines = []
        status = "PASS" if self.passed else "FAIL"
        lines.append(f"supervised run: {status} over {self.steps_run} steps "
                     f"({len(self.checks)} checked online)")
        if self.resumed_from is not None:
            lines.append(f"  resumed from journaled checkpoint at step "
                         f"{self.resumed_from}")
        if self.loud_steps:
            lines.append(f"  LOUD failures (NaN/Inf) at steps "
                         f"{sorted(self.loud_steps)}")
        if self.checks_rescued or self.checks_lost:
            lines.append(f"  watchdog: {self.checks_rescued} checks rescued "
                         f"by sync fallback, {self.checks_lost} lost")
        if self.degradations:
            lines.append(f"  degraded to sampling {len(self.degradations)}x "
                         f"(final effective check_every: "
                         f"{self.degraded_check_every})")
        if self.reestimations:
            lines.append(f"  thresholds re-estimated {self.reestimations}x "
                         f"on live batches")
        if self.flagged:
            lines.append(f"  first flagged (online): step "
                         f"{self.first_flagged_step}")
            if self.bisection is not None:
                lines.append("  " + self.bisection.summary())
            lines.append(f"  FIRST BAD STEP: {self.first_bad_step}")
            if self.bad_check is not None and self.bad_check.report:
                rep = self.bad_check.report
                for ln in rep.summary(max_rows=max_rows).splitlines():
                    lines.append("  " + ln)
            if self.localization is not None and self.localization.localized:
                lines.append(f"  LOCALIZED (rewrite): bug in module "
                             f"'{self.localization.localized}'")
        return "\n".join(lines)


class Supervisor:
    """Streaming lockstep supervisor for one (model, recipe) pairing.

    ``model`` is the port ``Model`` the reference step runs (on
    ``device``); ``params`` (``{name: tensor or numpy}``), when given, are
    loaded into it, else its own parameters are the initial state.
    ``batch_fn(step) -> batch`` defaults to the deterministic synthetic
    generator, which is also what makes bisection replay exact; its
    batches are moved to ``device``.  Pass ``candidate`` to drive a custom
    ``CandidateStep``; by default one is built from ``pcfg``.
    """

    def __init__(self, model, cfg, pcfg: ParallelConfig, opt,
                 params=None, scfg: Optional[SuperviseConfig] = None,
                 batch_fn: Optional[Callable[[int], dict]] = None,
                 batch_size: int = 4, seq_len: int = 32,
                 candidate: Optional[CandidateStep] = None,
                 log_fn: Optional[Callable[[str], None]] = None,
                 fault: Optional[FaultInjector] = None, device="cuda"):
        self.model, self.cfg, self.pcfg, self.opt = model, cfg, pcfg, opt
        self.device = resolve_device(device)
        self.scfg = scfg or SuperviseConfig()
        self._params = named_params(model)
        if params is not None:
            load_params(self._params, inputs_on(self.device, params)[0])
        self.params0 = {k: p.detach().clone()
                        for k, p in self._params.items()}
        self.batch_fn = batch_fn or (
            lambda step: make_batch(cfg, batch_size, seq_len,
                                    seed=self.scfg.seed, step=step,
                                    device=self.device))
        self.log = log_fn or (lambda s: None)
        self.work_dir = (self.scfg.work_dir
                         or tempfile.mkdtemp(prefix="ttrace_supervise_"))
        self.keeper = CheckpointKeeper(os.path.join(self.work_dir, "ckpt"),
                                       keep=self.scfg.ckpt_keep,
                                       background=self.scfg.overlap)
        self.keeper.on_save = self._on_ckpt_saved
        # a step's async check resolves at most async_window * check_every
        # puts after its own, and pinning happens at resolution — the ring
        # must still hold the step then, or flagged evidence is lost (the
        # "pinned steps are never dropped" contract).  check_every = 0 runs
        # no checks at all, so nothing constrains the ring (this used to
        # blow the window up to async_window * check_every and keep every
        # trace of the run live — the "checking off slower than checking
        # on" bench anomaly)
        if self.scfg.check_every > 0:
            min_window = min(self.scfg.async_window
                             * self.scfg.check_every + 1,
                             self.scfg.steps + 1)
        else:
            min_window = 1
        self.ring = TraceRing(
            window=max(self.scfg.ring_window, min_window),
            spill_dir=(os.path.join(self.work_dir, "spill")
                       if self.scfg.spill else None),
            spill_keep=self.scfg.spill_keep,
            background=self.scfg.overlap)
        self.candidate = candidate
        self.pipe: Optional[AsyncCheckPipeline] = None
        self._ref_step = None
        self._ref_state = self._cand_state = None
        self._estimator = None
        self._bad_entry = None
        #: ((ref_params, ref_opt), (cand_params, cand_opt)) after the loop
        self.state = None
        # ---- fault tolerance ----------------------------------------------
        self.fault = fault
        self.journal: Optional[Journal] = None
        self.watchdog = Watchdog(self.scfg.watchdog_timeout_s,
                                 retries=self.scfg.watchdog_retries,
                                 on_event=self._on_wd_event)
        self.degrade = DegradationController(
            check_every=max(1, self.scfg.check_every),
            degrade_after=self.scfg.degrade_after,
            max_mult=self.scfg.degrade_max_mult,
            on_event=self._on_wd_event)
        self.ring.on_spill = self._on_spilled
        if fault is not None:
            self.ring.fault_hook = fault.spill_writer

    # ---- journal + watchdog plumbing ---------------------------------------
    def _j(self, etype: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(etype, **fields)

    def _config_dict(self) -> dict:
        sc = self.scfg
        return {k: getattr(sc, k) for k in JournalState.CONFIG_KEYS}

    def _on_wd_event(self, ev: WatchdogEvent) -> None:
        """Watchdog/degradation events: journaled + logged as they fire."""
        if ev.kind in ("degrade", "recover"):
            self._j(ev.kind, step=ev.step, detail=ev.detail)
        else:
            self._j("watchdog", step=ev.step, kind=ev.kind, detail=ev.detail)
        self.log(f"  [supervise] watchdog: {ev}")

    def _on_ckpt_saved(self, step: int, root: str) -> None:
        # fires on the checkpoint writer's thread once the write landed
        if self.fault is not None:
            self.fault.post_ckpt(step, root)
        self._j("ckpt", step=step)

    def _on_spilled(self, step: int, root: str) -> None:
        # fires on the spill writer's thread once both sides landed
        if self.fault is not None:
            self.fault.post_spill(step, root)
        self._j("spill", step=step)

    def _sync_from_ring(self, step: int) -> StepCheck:
        """The watchdog's escalation target: recompute a timed-out check
        synchronously from the retained host traces.  Raises ``KeyError``
        when the ring no longer holds the step (check is then LOST)."""
        ref_tr, cand_tr = self.ring.get(step)
        return self.pipe.check_sync(step, ref_tr, cand_tr)

    # ---- build (thresholds + steps) ------------------------------------------
    def _batch(self, step: int) -> dict:
        return inputs_on(self.device, self.batch_fn(step))[0]

    def _loss_call(self, batch, ctx):
        return self.model.loss(batch, ctx=ctx)[0]

    def _build(self):
        sc = self.scfg
        batch0 = self._batch(0)
        t0 = time.perf_counter()
        if self.candidate is None:
            self.candidate = CandidateStep.build(self.cfg, self.pcfg,
                                                 self.params0, self.opt,
                                                 device=self.device)
        eps = sc.eps if sc.eps is not None else self.candidate.eps
        self.eps = eps
        load_params(self._params, self.params0)
        ref_runner = make_model_runner(self.model, self.opt,
                                       self.opt.init(self.params0),
                                       device=self.device)
        thr, _ = estimate_thresholds(ref_runner, batch0, eps, sc.margin,
                                     sc.seed)
        t_thr = time.perf_counter() - t0
        # margins start at the constant widening either way: until the first
        # live re-estimation lands, only the step-0 estimate exists and the
        # full batch-to-batch allowance is still needed
        self.pipe = AsyncCheckPipeline(thr, window=sc.async_window,
                                       drift_alpha=sc.drift_alpha,
                                       kind_scale=self.candidate.kind_scale)
        self.pipe.watchdog = self.watchdog
        self.pipe.fallback = self._sync_from_ring
        self.pipe.on_epoch = lambda s, t, km: self._j(
            "epoch", from_step=s, thresholds=thresholds_to_payload(t),
            kind_mult=km, reestimated=True)
        if self.fault is not None:
            self.pipe.tap_future = self.fault.check_future

        t0 = time.perf_counter()
        self._ref_step = make_trace_step(self._loss_call, self.opt,
                                         self._params)
        self._ref_state = (self.params0, self.opt.init(self.params0))
        self._cand_state = (self.candidate.params0,
                            self.candidate.opt_state0)
        timings = {"thresholds_s": t_thr}
        if sc.reestimate_every:
            self._estimator = make_pair_estimator(
                self._loss_call, self.opt, self._params, batch0, eps,
                sc.margin, sc.seed)
            # run (and discard) one estimate now, so the first live epoch
            # does not carry first-call costs inside the steady loop
            t1 = time.perf_counter()
            self._estimator(self._ref_state[0], self._ref_state[1], batch0)
            timings["estimator_warmup_s"] = time.perf_counter() - t1
        timings["build_s"] = time.perf_counter() - t0
        return thr, timings

    # ---- periodic threshold re-estimation ----------------------------------
    def _reestimate(self, k: int, rp, rs, batch, res: SuperviseResult):
        """Dispatch the live-batch pair estimate and register it as a
        PENDING threshold epoch: the device computation overlaps the
        training steps behind it, and the pipeline resolves it the moment a
        check at step >= k needs the epoch (or opportunistically once the
        reduction is ready) — bit-identical thresholds to the synchronous
        stall, none of the stall.  From the first live estimate on, the
        union tracks the real noise level and the constant widening
        tightens to the re-estimated multipliers (steps before this keep
        SUPERVISED_KIND_MULT)."""
        t0 = time.perf_counter()
        resolve = self._estimator.submit(rp, rs, batch, step=k)
        self.pipe.schedule_epoch(k, resolve,
                                 kind_mult=REESTIMATED_KIND_MULT)
        if not self.scfg.overlap:
            self.pipe.settle_epochs(k)       # the lockstep path blocks here
        res.reestimations += 1
        res.timings["reestimate_s"] = (res.timings.get("reestimate_s", 0.0)
                                       + time.perf_counter() - t0)
        self.log(f"  [supervise] step {k}: live-batch threshold estimate "
                 f"dispatched (epoch {res.reestimations})")

    # ---- main loop ---------------------------------------------------------
    def run(self) -> SuperviseResult:
        sc = self.scfg
        thr, timings = self._build()
        res = SuperviseResult(flagged=False, steps_run=0,
                              first_flagged_step=None, first_bad_step=None,
                              thresholds=thr, work_dir=self.work_dir)
        res.timings = timings
        if sc.journal:
            self.journal = Journal(journal_path(self.work_dir))
            self._j("start", **self._config_dict())
        return self._run_loop(res, start=0, flagged_steps=[],
                              entry=(self._ref_state, self._cand_state))

    def resume(self) -> SuperviseResult:
        """Re-enter a killed supervised run from its journal + work dir.

        Replays the journal to rebuild resolved verdicts and the settled
        threshold-epoch schedule, restores both sides from the newest
        DURABLE checkpoint consistent with that history (CRC-verified;
        torn writes from the crash are discarded loudly), and re-enters
        the lockstep loop there.  Determinism of the loop (stateless batch
        generator, bit-exact restore, once-compiled steps) makes the
        resumed run converge to the same flagged steps, rel-errs,
        threshold epochs and first-bad-step as an uninterrupted run —
        only per-step host losses before the resume point are NaN
        placeholders (the journal deliberately never syncs device losses).
        """
        sc = self.scfg
        if not sc.work_dir:
            raise ValueError("resume() needs scfg.work_dir — the journal "
                             "and checkpoints of the run to resume")
        js = JournalState(Journal.read(journal_path(self.work_dir)))
        mism = js.config_mismatches(self._config_dict())
        if mism:
            raise ValueError("refusing to resume with a drifted config "
                             "(verdicts would silently change): "
                             + "; ".join(mism))
        thr, timings = self._build()
        # durable checkpoints: on disk AND CRC-clean — a write torn by the
        # crash is discarded here, loudly
        self.keeper.rescan()
        for s in list(self.keeper.steps):
            if not self.keeper.verify(s):
                self.watchdog.event("loud", s,
                                    "corrupt checkpoint discarded at resume")
                self.keeper.discard(s)
        self.ring.rescan()
        start = js.resume_step(self.keeper.steps)
        res = SuperviseResult(flagged=False, steps_run=0,
                              first_flagged_step=None, first_bad_step=None,
                              thresholds=thr, work_dir=self.work_dir)
        res.timings = timings
        res.resumed_from = start
        # install the journaled threshold schedule below the entry step;
        # re-estimations at steps >= start re-run deterministically in the
        # loop (their pending epochs died with the process)
        below = js.epochs_below(start)
        for s, thr_e, km in below:
            self.pipe.swap_thresholds(thr_e, s, kind_mult=km)
        res.reestimations = len(below)
        # journaled verdicts below the entry step are final; checks at
        # steps >= start recompute to bit-identical reports
        flagged_steps: list[int] = []
        for s in sorted(js.verdicts):
            if s >= start:
                continue
            rep = js.verdicts[s]
            res.checks[s] = rep
            if rep is not None:
                if not rep.passed:
                    flagged_steps.append(s)
                    self.ring.pin(s)
                if rep.loud:
                    res.loud_steps.append(s)
        res.losses = [float("nan")] * start
        res.cand_losses = [float("nan")] * start
        entry = (self._ref_state, self._cand_state)
        if start in self.keeper.steps:
            entry = self.keeper.load(start, self._ref_state,
                                     self._cand_state)
        if sc.journal:
            self.journal = Journal(journal_path(self.work_dir))
            self._j("resume", step=start, durable=list(self.keeper.steps))
        self.log(f"  [supervise] resuming at step {start} "
                 f"({len(res.checks)} journaled verdicts restored)")
        return self._run_loop(res, start=start,
                              flagged_steps=flagged_steps, entry=entry)

    def _save_ckpt(self, k: int, ref_state, cand_state) -> None:
        try:
            self.keeper.save(k, ref_state, cand_state)
        except Exception as e:        # noqa: BLE001 — surfaced + retried
            # an earlier enqueued save failed; the writer restarted, this
            # save re-submits — degraded checkpoint coverage is loud
            self.watchdog.event("loud", k, f"ckpt writer: {e}")
            self.keeper.save(k, ref_state, cand_state)

    def _ring_put(self, k: int, ref_tr, cand_tr) -> None:
        try:
            self.ring.put(k, ref_tr, cand_tr)
        except Exception as e:        # noqa: BLE001 — surfaced, not fatal
            # the put itself landed in memory before the stored writer
            # error surfaced; the worker restarts on the next eviction and
            # only spill coverage (not training) degraded
            self.watchdog.event("loud", k, f"spill writer: {e}")

    def _run_loop(self, res: SuperviseResult, start: int,
                  flagged_steps: list[int], entry) -> SuperviseResult:
        # the finally matters on the crash path: a loop that dies mid-run
        # (fault injection, a real bug) must still drain the journal's
        # write queue before an in-process resume() reads the file, and
        # must not leak the spill/ckpt worker threads of a finished run
        try:
            return self._run_loop_inner(res, start, flagged_steps, entry)
        finally:
            if self.journal is not None:
                self.journal.close()
            self.ring.stop()
            self.keeper.stop()

    def _run_loop_inner(self, res: SuperviseResult, start: int,
                        flagged_steps: list[int], entry) -> SuperviseResult:
        sc = self.scfg
        timings = res.timings
        self._step_marks = []
        (rp, rs), (cp, cs) = entry
        cand_step = self.candidate.step
        t_loop = time.perf_counter()
        t_warm = None          # set once compile-bearing first steps are done
        k = start
        # a resumed run whose journaled history already flagged goes
        # straight to diagnosis (the original run stopped there too)
        if not (flagged_steps and sc.stop_on_flag):
            for k in range(start, sc.steps):
                t_step = time.perf_counter()
                if self.fault is not None:
                    self.fault.step_start(k)       # crash fault fires here
                if k == start + 2:
                    # the one wait outside the pipeline: first calls done
                    self._sync()
                    t_warm = time.perf_counter()
                if k % sc.ckpt_every == 0:
                    self._save_ckpt(k, (rp, rs), (cp, cs))
                batch = self._batch(k)
                if (sc.reestimate_every and k
                        and k % sc.reestimate_every == 0):
                    self._reestimate(k, rp, rs, batch, res)
                # both steps dispatch back-to-back on one stream — no host
                # barrier between them; the host blocks only where the
                # pipeline consumes values
                marks = [self._mark()]
                ref_tr, rp, rs = self._ref_step(rp, rs, batch)
                marks.append(self._mark())
                cand_tr, cp, cs = cand_step(cp, cs, batch)
                marks.append(self._mark())
                if self.fault is not None:
                    cand_tr = self.fault.cand_trace(k, cand_tr)
                res.losses.append(ref_tr.loss)
                res.cand_losses.append(cand_tr.loss)
                t_check = time.perf_counter()
                if (sc.check_every > 0 and sc.async_window > 0
                        and k % sc.check_every == 0):
                    # saturation probe feeds the degradation policy BEFORE
                    # the cadence decision: a sick pipeline raises the
                    # effective cadence (checking degrades to sampling)
                    # instead of blocking the loop on every submit
                    self.degrade.note(k, self.pipe.saturated)
                checked = False
                if (sc.check_every > 0
                        and k % self.degrade.effective_check_every == 0):
                    checked = True
                    if sc.async_window == 0:
                        done = [self.pipe.check_sync(k, ref_tr, cand_tr)]
                    else:
                        done = self.pipe.submit(k, ref_tr, cand_tr)
                else:
                    done = self.pipe.poll()
                self._j("step", step=k, checked=checked)
                self._ring_put(k, ref_tr, cand_tr)
                now = time.perf_counter()
                self._step_marks.append((k, marks, now - t_check,
                                         now - t_step))
                if (self._absorb(done, res, flagged_steps)
                        and sc.stop_on_flag):
                    k += 1
                    break
            else:
                k = sc.steps
        self.state = ((rp, rs), (cp, cs))
        t_drain = time.perf_counter()
        self._absorb(self.pipe.drain(), res, flagged_steps)
        timings["drain_s"] = time.perf_counter() - t_drain
        timings["steps"] = self._step_seconds()
        try:
            self.ring.flush()        # background spill writes land on disk
        except Exception as e:        # noqa: BLE001 — coverage loss, loud
            self.watchdog.event("loud", k, f"spill writer: {e}")
        try:
            self.keeper.flush()      # checkpoint writes are durable too
        except Exception as e:        # noqa: BLE001 — coverage loss, loud
            self.watchdog.event("loud", k, f"ckpt writer: {e}")
        res.steps_run = k
        res.losses = [float(x) for x in res.losses]
        res.cand_losses = [float(x) for x in res.cand_losses]
        ran = max(res.steps_run - start, 0)
        timings["loop_s"] = time.perf_counter() - t_loop
        timings["steps_per_s"] = ran / max(timings["loop_s"], 1e-9)
        if t_warm is not None and ran > 2:
            # steady-state rate: the first two steps carry first-call costs
            # (kernel loads, the allocator's first blocks)
            steady_s = time.perf_counter() - t_warm
            timings["steady_steps_per_s"] = (ran - 2) / max(steady_s, 1e-9)

        if flagged_steps:
            res.flagged = True
            res.first_flagged_step = min(flagged_steps)
            t0 = time.perf_counter()
            self._diagnose(res)
            timings["diagnose_s"] = time.perf_counter() - t0
        res.timings = timings
        res.checks_rescued = self.pipe.rescued
        res.checks_lost = self.pipe.lost
        res.watchdog_events = [str(e) for e in self.watchdog.events]
        res.degradations = [str(e) for e in self.degrade.events]
        res.degraded_check_every = (self.degrade.effective_check_every
                                    if self.degrade.degraded else None)
        self._j("end", steps_run=res.steps_run, flagged=res.flagged,
                first_bad_step=res.first_bad_step)
        if self.journal is not None:
            self.journal.close()
        return res

    # ---- per-step timing ----------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _mark(self):
        """A point on the device's timeline: a recorded CUDA event (no
        wait), or the host clock on the CPU, where ops run as called."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def _step_seconds(self) -> list[dict]:
        """Each loop step's reference and candidate seconds (between
        events on the stream for CUDA: device time, and the gaps where the
        device waited for the host's dispatch), the host seconds its check
        submission or poll took (resolutions the window forced included,
        and the ring's put), and the step's host wall seconds (checkpoint
        and spill hand-off included).  Waits for the device: called after
        the drain."""
        self._sync()
        out = []
        for k, (m0, m1, m2), check_s, wall_s in self._step_marks:
            if self.device.type == "cuda":
                ref_s = m0.elapsed_time(m1) / 1e3
                cand_s = m1.elapsed_time(m2) / 1e3
            else:
                ref_s, cand_s = m1 - m0, m2 - m1
            out.append({"step": k, "ref_s": ref_s, "cand_s": cand_s,
                        "check_s": check_s, "wall_s": wall_s})
        return out

    def _absorb(self, done: list[StepCheck], res: SuperviseResult,
                flagged_steps: list[int]) -> bool:
        hit = False
        for chk in done:
            res.checks[chk.step] = chk.report
            self._j("verdict", step=chk.step,
                    report=report_to_payload(chk.report))
            rep = chk.report
            if rep is not None and rep.loud:
                if chk.step not in res.loud_steps:
                    res.loud_steps.append(chk.step)
                self._j("loud", step=chk.step,
                        tensors=[r.name for r in rep.loud])
                self.log(f"  [supervise] step {chk.step} LOUD failure "
                         f"({len(rep.loud)} non-finite tensors)")
            if chk.flagged:
                flagged_steps.append(chk.step)
                if not self.ring.pin(chk.step):
                    self.log(f"  [supervise] step {chk.step} trace already "
                             f"evicted before its check resolved — raise "
                             f"ring_window or enable spill")
                hit = True
                self.log(f"  [supervise] step {chk.step} FLAGGED "
                         f"({len(chk.report.flagged)} tensors, localized: "
                         f"{chk.report.localized})")
        return hit

    # ---- diagnosis: bisect + localize --------------------------------------
    def _params_diverged(self, ckpt_step: int) -> bool:
        # host-only probe: just the two param trees, no opt state, no
        # device placement — O(log C) of these run per bisection.  The
        # threshold schedule (epoch + drift growth) is the pipeline's, so
        # the probe agrees with the online checks of that step.
        try:
            rp, cp = self.keeper.load_params_named(ckpt_step)
        except (ChecksumError, FileNotFoundError) as e:
            # corrupt payload: discard the checkpoint and answer "diverged"
            # — the search retreats toward step 0, and ``good`` is only
            # ever set from checkpoints that actually probed clean
            self.watchdog.event("loud", ckpt_step,
                                f"corrupt checkpoint probe: {e}")
            self.keeper.discard(ckpt_step)
            return True
        errs = batched_rel_err(rp, cp)
        return any(e > self.pipe.param_post_threshold(n, ckpt_step)
                   for n, e in errs.items())

    def _replay(self, start: int, end: int):
        """Deterministic sync-checked replay; returns the first flagged
        StepCheck and stashes the entry states + reference trace of that
        step for localization.  A checkpoint that fails CRC at restore is
        discarded and the replay retreats to an earlier one (ultimately
        the in-memory initial states) — a longer replay, never a wrong
        verdict built on corrupt state."""
        while True:
            try:
                (rp, rs), (cp, cs) = self.keeper.load(start, self._ref_state,
                                                      self._cand_state)
                break
            except (ChecksumError, FileNotFoundError) as e:
                self.watchdog.event("loud", start,
                                    f"corrupt checkpoint at replay: {e}")
                self.keeper.discard(start)
                earlier = [s for s in self.keeper.steps if s < start]
                if not earlier:
                    # _ref_state/_cand_state hold the build-time initial
                    # states (they are only ever used as templates)
                    (rp, rs), (cp, cs) = self._ref_state, self._cand_state
                    start = 0
                    break
                start = max(earlier)
        cand_step = self.candidate.step
        self._bad_entry = None
        for k in range(start, end + 1):
            entry = ((rp, rs), (cp, cs))
            batch = self._batch(k)
            ref_tr, rp, rs = self._ref_step(rp, rs, batch)
            cand_tr, cp, cs = cand_step(cp, cs, batch)
            if self.fault is not None:
                # an injected numeric fault is part of the run under
                # diagnosis: the replay must reproduce it, or bisection
                # would "lose" the verdict it is refining
                cand_tr = self.fault.cand_trace(k, cand_tr)
            chk = self.pipe.check_sync(k, ref_tr, cand_tr)
            if chk.flagged:
                self._bad_entry = (entry, ref_tr)
                return chk
        return None

    def _diagnose(self, res: SuperviseResult) -> None:
        sc = self.scfg
        try:
            self.keeper.flush()  # in-flight saves land before bisection
        except Exception as e:    # noqa: BLE001 — coverage loss, loud
            self.watchdog.event("loud", res.first_flagged_step or 0,
                                f"ckpt writer: {e}")
        res.bisection = bisect_first_bad(self.keeper.steps,
                                         res.first_flagged_step,
                                         self._params_diverged, self._replay)
        res.first_bad_step = res.bisection.first_bad_step
        res.bad_check = res.bisection.check
        self.ring.pin(res.first_bad_step)
        rep = res.bad_check.report if res.bad_check else None
        if (not sc.localize or rep is None
                or rep.localization_mode != "propagation"
                or getattr(self, "_bad_entry", None) is None):
            return
        # forward divergence: entry states still agree (this IS the first
        # bad step), so rewrite-mode module isolation applies as in the
        # single-step workflow (paper §3 step 5)
        ((rp, rs), (cp, cs)), ref_tr = self._bad_entry
        load_params(self._params, rp)
        ref_runner = make_model_runner(self.model, self.opt, rs,
                                       device=self.device)
        cand_runner = self.candidate.make_runner(cp, cs)
        res.localization = localize_with_rewrites(
            ref_runner, cand_runner, self._batch(res.first_bad_step),
            ref_tr, self.pipe.thresholds_for(res.first_bad_step))

"""TTrace top-level API (paper §3 debugging workflow): the port of
``repro/core/harness.py``.

    result = ttrace_check(
        reference=make_model_runner(model, opt, opt_state),
        candidate=<any runner>,
        batch=batch,
        eps=machine epsilon of the recipe,
    )

A *runner* is ``fn(batch, rewrites) -> Trace``.  The harness performs:
  step 1-2  reference run + threshold estimation (eps-perturbed reference)
  step 3    candidate run with trace collection
  step 4    differential testing -> Report
  step 5    if flagged: rewrite-mode localization (module-isolated inputs)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.checker import (Report, compare_traces,
                                      localize_with_rewrites)
from repro_torch.core.collector import (Trace, trace_pair_step,
                                        trace_train_step)
from repro_torch.core.thresholds import (MACHINE_EPS, Thresholds,
                                         estimate_thresholds)


@dataclass
class TTraceResult:
    report: Report                      # step-4 differential report
    localization: Optional[Report]      # step-5 rewrite-mode report (if run)
    thresholds: Thresholds
    reference: Trace
    candidate: Trace
    seconds: dict = field(default_factory=dict)   # wall time of each step

    @property
    def passed(self) -> bool:
        return self.report.passed

    @property
    def localized_module(self) -> Optional[str]:
        if self.localization is not None and self.localization.localized:
            return self.localization.localized
        return self.report.localized

    def summary(self) -> str:
        s = self.report.summary()
        if self.localization is not None:
            s += "\n--- rewrite-mode localization ---\n"
            s += self.localization.summary()
        return s


def _on_device(v, device: torch.device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            ).to(device)


def runner_device(model, device) -> torch.device:
    """The device a runner over ``model`` runs on; the model must live there."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, runner on {dev}")
    return dev


def inputs_on(dev: torch.device, batch: dict, rewrites=None):
    """A runner's batch leaves and rewrites (numpy or tensors) on ``dev``;
    callable rewrites pass through."""
    b = {k: _on_device(v, dev) for k, v in batch.items()}
    rw = (None if rewrites is None else
          {k: v if callable(v) else _on_device(v, dev)
           for k, v in rewrites.items()})
    return b, rw


def make_model_runner(model, opt=None, opt_state=None,
                      device="cuda") -> Callable:
    """Reference runner over a port ``Model`` living on ``device``.

    Batch leaves and rewrites (numpy or tensors) are moved to ``device``;
    the model's parameters are never changed by a run.  ``run.pair(batch2)``
    collects the two rows of a batch stacked on a leading axis of 2 (the
    estimate's base and perturbed runs of float-input models).
    """
    dev = runner_device(model, device)

    def run(batch, rewrites=None) -> Trace:
        b, rw = inputs_on(dev, batch, rewrites)
        tr, _, _ = trace_train_step(model, b, opt=opt, opt_state=opt_state,
                                    rewrites=rw)
        return tr

    def run_pair(batch2):
        b2, _ = inputs_on(dev, batch2)
        return trace_pair_step(model, b2, opt=opt, opt_state=opt_state)

    run.pair = run_pair
    return run


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def ttrace_check(reference: Callable, candidate: Callable, batch: dict,
                 eps: float = MACHINE_EPS["float32"], margin: float = 8.0,
                 localize: bool = True, seed: int = 0) -> TTraceResult:
    seconds = {}
    t0 = time.perf_counter()
    thr, ref_trace = estimate_thresholds(reference, batch, eps, margin, seed)
    _sync()
    t1 = time.perf_counter()
    cand_trace = candidate(batch, None)
    _sync()
    t2 = time.perf_counter()
    report = compare_traces(ref_trace, cand_trace, thr)
    t3 = time.perf_counter()
    seconds.update(estimate=t1 - t0, candidate=t2 - t1, compare=t3 - t2)
    loc = None
    if localize and not report.passed:
        loc = localize_with_rewrites(reference, candidate, batch, ref_trace,
                                     thr)
        _sync()
        seconds["localize"] = time.perf_counter() - t3
    return TTraceResult(report=report, localization=loc, thresholds=thr,
                        reference=ref_trace, candidate=cand_trace,
                        seconds=seconds)


def ttrace_supervise(model, cfg, pcfg, opt, params=None, steps: int = 8,
                     batch_fn: Optional[Callable] = None, device="cuda",
                     **kwargs):
    """Multi-step analogue of ``ttrace_check``: reference and candidate
    train in lockstep for ``steps`` steps with online (async) checks; on a
    flag the run is bisected to the first bad step and localized.

    A thin facade over ``repro_torch.supervise.Supervisor``: ``kwargs`` are
    ``SuperviseConfig`` fields plus ``batch_size``/``seq_len``/``log_fn``.
    Returns a ``SuperviseResult``."""
    from repro_torch.supervise import SuperviseConfig, Supervisor
    sup_kw = {k: kwargs.pop(k) for k in ("batch_size", "seq_len", "log_fn")
              if k in kwargs}
    scfg = SuperviseConfig(steps=steps, **kwargs)
    return Supervisor(model, cfg, pcfg, opt, params=params, scfg=scfg,
                      batch_fn=batch_fn, device=device, **sup_kw).run()

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

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import spans
from repro_torch.core.checker import (Report, compare_traces,
                                      localize_with_rewrites)
from repro_torch.core.collector import (SECTION_FIELDS, Trace,
                                        trace_pair_step, trace_train_step)
from repro_torch.core.thresholds import (MACHINE_EPS, Thresholds,
                                         estimate_thresholds)


@dataclass
class TTraceResult:
    report: Report                      # step-4 differential report
    localization: Optional[Report]      # step-5 rewrite-mode report (if run)
    thresholds: Thresholds
    reference: Trace
    candidate: Trace
    seconds: dict = field(default_factory=dict)   # each step's, each span's
    counts: dict = field(default_factory=dict)    # calls, bytes, allocator

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
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.device.type == "cpu" and device.type != "cpu":
        spans.count("h2d_bytes", spans.nbytes(t))
    return t.to(device)


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
    estimate's base and perturbed runs of float-input models);
    ``run.tap_shape(batch)`` is the shape of the ``embedding/output`` tap
    a run of a token batch gives, None without tokens (the estimate draws
    its perturbation during the base run).
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

    def tap_shape(batch):
        if "tokens" not in batch:
            return None
        return (tuple(np.shape(batch["tokens"]))
                + (model.embedding.word_embeddings.shape[1],))

    run.pair = run_pair
    run.tap_shape = tap_shape
    return run


def make_decode_runner(model, decode_fn: Optional[Callable] = None,
                       device="cuda") -> Callable:
    """Inference-mode runner (paper §7's extension to inference): steps the
    decode path over ``batch["tokens"]`` (B, T) from an empty cache of T
    positions, tapping each step's logits as ``decode.t{t}/logits`` and
    each leaf of the final cache as ``decode.final_cache.{name}/value``
    (``name`` as the reference's ``flatten_named`` gives it).  Leaves stay
    on the device; ``loss`` is the mean of the last step's logits.
    ``decode_fn(caches, tokens, pos)`` defaults to ``model.decode_step``;
    pass another implementation (e.g. ``functools.partial(
    model.decode_step, mla_impl="naive")``) for the other side.

    A decode runner has no rewrite surface: check it with ``ttrace_check(
    ..., estimate=False, localize=False)``."""
    from repro_torch.checkpoint.store import flatten_named

    dev = runner_device(model, device)
    fn = decode_fn or model.decode_step

    def run(batch, rewrites=None) -> Trace:
        if rewrites:
            raise ValueError("a decode runner takes no rewrites; pass "
                             "localize=False to ttrace_check")
        toks, _ = inputs_on(dev, {"tokens": batch["tokens"]})
        toks = toks["tokens"]
        B, T = toks.shape
        cache = model.init_cache(B, T)
        tr = Trace()
        with torch.no_grad():
            for t in range(T):
                logits, cache = fn(cache, toks[:, t:t + 1], t)
                tr.activations[f"decode.t{t}/logits"] = logits
        for name, leaf in flatten_named(cache).items():
            tr.activations[f"decode.final_cache.{name}/value"] = leaf
        tr.meta["fwd_order"] = list(tr.activations)
        tr.loss = float(logits.float().mean())
        return tr

    return run


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _to_host(sec, name) -> Optional[torch.device]:
    """Moves leaf ``name`` of ``sec`` to the host; its device if it moved."""
    x = sec.raw(name)
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        return None
    spans.count("d2h_bytes", spans.nbytes(x))
    sec[name] = x.cpu()
    return x.device


@contextlib.contextmanager
def _on_host(sections):
    """Every device leaf of ``sections`` on the host for the span of the
    block, back on its device after: frees the device for the
    localizer's two traced runs.  Both moves are spans ``moves``."""
    with spans.span("moves"):
        moved = [(sec, name, dev) for sec in sections for name in list(sec)
                 if (dev := _to_host(sec, name)) is not None]
    try:
        yield
    finally:
        with spans.span("moves"):
            for sec, name, dev in moved:
                x = sec.raw(name)
                spans.count("h2d_bytes", spans.nbytes(x))
                sec[name] = x.to(dev)


def ttrace_check(reference: Callable, candidate: Callable, batch: dict,
                 eps: float = MACHINE_EPS["float32"], margin: float = 8.0,
                 localize: bool = True, seed: int = 0,
                 estimate: bool = True) -> TTraceResult:
    """``estimate=False`` skips step 1-2's estimate: floor-only thresholds,
    ``margin * floor_mult * eps`` for every tensor (decode runners have
    integer inputs and no rewrite surface); ``seconds["estimate"]`` is
    then the reference run.

    Step 5 reads only the reference's activations: every other section
    of the two traces waits on the host while it runs (the time is in
    ``seconds["localize"]``)."""
    loc = None
    with spans.check() as log:
        with spans.span("estimate", alloc=True):
            if estimate:
                thr, ref_trace = estimate_thresholds(reference, batch, eps,
                                                     margin, seed)
            else:
                thr = Thresholds(eps=eps, margin=margin)
                with spans.span("run"):
                    ref_trace = reference(batch, None)
            _sync()
        with spans.span("candidate", alloc=True):
            cand_trace = candidate(batch, None)
            _sync()
        with spans.span("compare", alloc=True):
            report = compare_traces(ref_trace, cand_trace, thr)
        if localize and not report.passed:
            with spans.span("localize", alloc=True):
                idle = [getattr(tr, f) for tr in (ref_trace, cand_trace)
                        for f in SECTION_FIELDS
                        if tr is cand_trace or f != "activations"]
                with _on_host(idle):
                    loc = localize_with_rewrites(reference, candidate, batch,
                                                 ref_trace, thr)
                _sync()
    return TTraceResult(report=report, localization=loc, thresholds=thr,
                        reference=ref_trace, candidate=cand_trace,
                        seconds=log.seconds, counts=log.counts)


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

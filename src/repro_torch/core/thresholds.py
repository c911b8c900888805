"""Expected FP round-off estimation (paper §5): the port of
``repro/core/thresholds.py``.

The reference runs twice — on X and on X + dX with ||dX|| ~= eps * ||X|| —
and the induced relative error of every traced tensor becomes its
threshold (times a margin).  Token-input models are perturbed at the
embedding output through the rewrite mechanism.  The perturbation's
direction depends only on the seed and the tap's shape, so a worker
thread draws it on the host while the base run holds the device; the
part that depends on the tap is finished on the tap's device from pinned
copies, bit for bit ``generator.perturb`` of the tap.

``make_pair_estimator`` is the supervised loop's re-estimation: built
once, its ``submit`` dispatches the pair run and the reductions and
returns the estimate's resolution, so it overlaps the training steps
behind it (``diff_sections_async``).
"""
from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import canonical as C
from repro_torch.core import spans
from repro_torch.core.collector import Trace, to_numpy
from repro_torch.core.generator import (perturb, perturb_direction,
                                        perturb_scale)
from repro_torch.core.relerr_engine import (_to_rel_err, rel_err_np,
                                            section_sq_norms, sq_norms_async)

MACHINE_EPS = {
    "float32": 2.0 ** -24,
    "bfloat16": 2.0 ** -8,
    "float16": 2.0 ** -11,
    # fp8 recipes accumulate in >=bf16 (paper §6.7): thresholds are expressed
    # in bf16 epsilons, perturbations injected at bf16 magnitude.
    "float8_e4m3fn": 2.0 ** -8,
}


def rel_err(a, b) -> float:
    """Relative Frobenius error ||a-b|| / ||a|| (paper §2.2) for one pair.

    Section-scale comparisons go through ``relerr_engine.batched_rel_err``;
    this per-pair float64 form stays as the reference semantic.
    """
    return rel_err_np(a, b)


@dataclass
class Thresholds:
    eps: float
    margin: float = 8.0
    floor_mult: float = 4.0
    per_tensor: dict[str, dict[str, float]] = field(default_factory=dict)
    # per kind: {name: estimated FP rel err}

    # Post-step parameters pass through Adam's elementwise m/sqrt(v)
    # normalization, which amplifies uncorrelated reduction-order noise
    # more than the correlated estimation perturbation; a wider margin
    # absorbs that (bug-induced errors are ~100x above, Fig 8).
    kind_margins = {C.KIND_PARAM_POST: 64.0}

    def threshold(self, kind: str, name: str) -> float:
        est = self.per_tensor.get(kind, {}).get(name, 0.0)
        margin = self.kind_margins.get(kind, self.margin)
        return margin * max(est, self.floor_mult * self.eps)

    def union(self, other: "Thresholds") -> "Thresholds":
        """Elementwise-max merge of two estimates (same eps/margin): a
        re-estimate only ever widens the per-tensor floors."""
        per = {k: dict(v) for k, v in self.per_tensor.items()}
        for kind, named in other.per_tensor.items():
            d = per.setdefault(kind, {})
            for n, e in named.items():
                d[n] = max(d.get(n, 0.0), e)
        return Thresholds(eps=self.eps, margin=self.margin,
                          floor_mult=self.floor_mult, per_tensor=per)


def diff_sections_async(t1: Trace, t2: Trace):
    """Dispatch one pair reduction per kind of two traces and return
    ``resolve() -> {kind: {name: rel_err}}``, with ``resolve.ready()``
    probing the futures: the supervised re-estimate holds it as an
    in-flight epoch, and the lockstep loop resolves it at once, so both see
    the same values."""
    pend = []
    for kind in (C.KIND_ACT, C.KIND_ACT_GRAD, C.KIND_PARAM_GRAD,
                 C.KIND_MAIN_GRAD, C.KIND_PARAM_POST):
        s1, s2 = t1.section(kind), t2.section(kind)
        names = [n for n in s1 if n in s2]
        fut = sq_norms_async([s1.raw(n) for n in names],
                             [s2.raw(n) for n in names])
        pend.append((kind, names, fut))

    def resolve() -> dict[str, dict[str, float]]:
        out = {}
        for kind, names, fut in pend:
            errs = _to_rel_err(np.asarray(fut, np.float64))
            out[kind] = {n: float(e) for n, e in zip(names, errs)}
        return out

    resolve.ready = lambda: all(f.is_ready() for _, _, f in pend)
    return resolve


def _diff_sections(t1: Trace, t2: Trace) -> dict[str, dict[str, float]]:
    """{kind: {name: rel_err}} between two traces, one reduction per kind
    (the engine's size-chosen mode, as the one-shot check compares)."""
    out = {}
    for kind in (C.KIND_ACT, C.KIND_ACT_GRAD, C.KIND_PARAM_GRAD,
                 C.KIND_MAIN_GRAD, C.KIND_PARAM_POST):
        s1, s2 = t1.section(kind), t2.section(kind)
        names = [n for n in s1 if n in s2]
        errs = _to_rel_err(section_sq_norms([s1.raw(n) for n in names],
                                            [s2.raw(n) for n in names]))
        out[kind] = {n: float(e) for n, e in zip(names, errs)}
    return out


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return np.issubdtype(np.asarray(v).dtype, np.floating)


def _float_keys(batch: dict) -> list[str]:
    return [k for k, v in batch.items() if _is_float(v) and k != "loss_mask"]


_EMB_TAP = "embedding/output"
# the tap dtypes to_numpy keeps; it widens every other float to float32
_HOST_DTYPE = {torch.float16: np.float16, torch.float64: np.float64,
               torch.float32: np.float32}

# (pid, the one host thread that draws directions): started at first use,
# and again in a forked child, which has no thread of its parent's
_WORKER: tuple | None = None
_WORKER_LOCK = threading.Lock()
# runner -> (its last token batch's input shapes, the tap shape they gave)
_SEEN: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _worker() -> ThreadPoolExecutor:
    global _WORKER
    with _WORKER_LOCK:
        if _WORKER is None or _WORKER[0] != os.getpid():
            _WORKER = (os.getpid(), ThreadPoolExecutor(
                1, thread_name_prefix="ttrace-perturb"))
        return _WORKER[1]


def _input_shapes(batch: dict) -> tuple:
    return tuple((k, tuple(np.shape(v))) for k, v in batch.items())


def _host_f32(shape, pinned: bool) -> torch.Tensor:
    """A float32 host buffer; pinned ones come from torch's pinned-memory
    cache, so every check after the first reuses the same blocks."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=pinned)


def _draw(buf: torch.Tensor, seed: int):
    return perturb_direction(buf.shape, seed, out=buf.numpy())[1]


def _prefetch(run_trace, batch: dict, seed: int):
    """Starts drawing the direction of a token batch's perturbation on the
    worker thread, for the tap shape the base run should give: the shape
    the runner's last estimate saw for a batch of the same input shapes,
    else the runner's ``tap_shape(batch)``.  Returns ``(buffer, future of
    ||d||)``, or None for float inputs or with no shape to draw for."""
    if _float_keys(batch):
        return None
    try:
        seen = _SEEN.get(run_trace)
    except TypeError:               # a runner that takes no weak reference
        seen = None
    hint = getattr(run_trace, "tap_shape", None)
    if seen and seen[0] == _input_shapes(batch):
        shape = seen[1]
    else:
        shape = None if hint is None else hint(batch)
    if shape is None:
        return None
    buf = _host_f32(shape, torch.cuda.is_initialized())
    return buf, _worker().submit(_draw, buf, seed)


def _remember(run_trace, batch: dict, base_trace: Trace) -> None:
    if _EMB_TAP in base_trace.activations:
        try:
            _SEEN[run_trace] = (_input_shapes(batch),
                                base_trace.activations.shape_of(_EMB_TAP))
        except TypeError:
            pass


def _tap_rewrites(base_trace: Trace, eps: float, seed: int,
                  prefetched=None) -> dict:
    """``{embedding/output: perturb(to_numpy(tap), eps, seed)}`` bit for bit,
    as a tensor on the tap's device.  ``x`` comes to the host once, for
    ``||x||``; ``d`` (``prefetched`` if it was drawn for the tap's shape,
    else drawn now) goes up into the rewrite's own storage, which then
    takes ``d * s + x`` as two float32 operations (numpy's ``x + d * s``:
    the sum commutes)."""
    if _EMB_TAP not in base_trace.activations:
        raise ValueError("no float inputs and no embedding/output tap to perturb")
    x = torch.as_tensor(base_trace.activations.raw(_EMB_TAP)).detach()
    cuda = x.device.type != "cpu"
    x32 = x.float()                 # as to_numpy and perturb take it
    if cuda:
        xh = _host_f32(x.shape, True)
        xh.copy_(x32, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        spans.count("d2h_bytes", spans.nbytes(xh))
    else:
        xh = x32
    if x.dtype != torch.float64:
        # the add widens the tap exactly: no f32 copy of a bf16 tap stays
        # beside the rewrite
        x32 = x
    nx = np.linalg.norm(xh.numpy())
    if prefetched is not None and tuple(prefetched[0].shape) == tuple(x.shape):
        spans.count("prefetched", 1)
        dh, fut = prefetched
        # a span's key is <step>.<name>: estimate.perturb.wait
        with spans.span("perturb.wait"):
            nd = fut.result()
    else:
        spans.count("redrawn", 1)
        dh = _host_f32(x.shape, cuda)
        nd = _draw(dh, seed)
    s = perturb_scale(nx, nd, eps)
    dt = x.dtype if x.dtype in _HOST_DTYPE else torch.float32
    if s is not None and np.result_type(np.float32, s) != np.float32:
        # numpy combines in the scale's wider dtype: so does this
        rew = torch.from_numpy((xh.numpy() + dh.numpy() * s)
                               .astype(_HOST_DTYPE[dt]))
        if cuda:
            spans.count("h2d_bytes", spans.nbytes(rew))
        return {_EMB_TAP: rew.to(x.device)}
    rew = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if s is None:
        rew.copy_(x32)
    else:
        rew.copy_(dh, non_blocking=True)
        if cuda:
            spans.count("h2d_bytes", spans.nbytes(dh))
        rew.mul_(float(np.float32(s))).add_(x32)
    return {_EMB_TAP: rew.to(dt)}


def perturbed_batch_or_rewrites(batch: dict, base_trace: Trace,
                                eps: float, seed: int = 0):
    """Returns (batch', rewrites').  Float model inputs are perturbed in the
    batch; token-only models are perturbed at the embedding output, and
    the rewrite goes back to the tap's device here, so the perturbed run
    copies nothing."""
    float_keys = _float_keys(batch)
    if float_keys:
        b2 = dict(batch)
        for i, k in enumerate(float_keys):
            b2[k] = perturb(to_numpy(batch[k]), eps, seed=seed + i)
        return b2, None
    return batch, _tap_rewrites(base_trace, eps, seed)


def estimate_thresholds(run_trace, batch: dict, eps: float,
                        margin: float = 8.0, seed: int = 0
                        ) -> tuple[Thresholds, Trace]:
    """``run_trace(batch, rewrites) -> Trace`` runs the REFERENCE.

    Returns (thresholds, base_reference_trace) — the base trace is reused as
    the reference side of the differential test, so threshold estimation
    costs exactly one extra iteration (paper §3 step 1).

    A runner with ``.pair`` collects the base and perturbed runs together
    when the batch has float inputs; token inputs stay serial (the
    embedding perturbation needs the base trace first), and the
    perturbation's direction is drawn on a worker thread during the base
    run where the tap's shape is known before it: from the runner's last
    estimate on a batch of the same shapes, or from its
    ``tap_shape(batch)``.
    """
    pair = getattr(run_trace, "pair", None)
    if pair is not None and _float_keys(batch):
        with spans.span("perturb"):
            b2, _ = perturbed_batch_or_rewrites(batch, None, eps, seed)
        with spans.span("run"):
            t1, t2 = pair({k: np.stack([to_numpy(batch[k]), to_numpy(b2[k])])
                           for k in batch})
    else:
        pre = _prefetch(run_trace, batch, seed)
        with spans.span("run"):
            t1 = run_trace(batch, None)
        with spans.span("perturb"):
            b2, rew = (perturbed_batch_or_rewrites(batch, t1, eps, seed)
                       if pre is None else
                       (batch, _tap_rewrites(t1, eps, seed, pre)))
        _remember(run_trace, batch, t1)
        with spans.span("run"):
            t2 = run_trace(b2, rew)
    with spans.span("sections"):
        per_tensor = _diff_sections(t1, t2)
    thr = Thresholds(eps=eps, margin=margin, per_tensor=per_tensor)
    return thr, t1


# ---------------------------------------------------------------------------
# Build-once pair estimator (periodic re-estimation, paper §5 live)
# ---------------------------------------------------------------------------


def make_pair_estimator(loss_call, opt, params: dict, batch: dict, eps: float,
                        margin: float = 8.0, seed: int = 0):
    """Build ``estimate(p, opt_state, batch, step=0) -> Thresholds`` over
    the leaves ``params`` that ``loss_call(batch, ctx)`` reads.

    ``estimate.submit(...)`` is the asynchronous form: it runs the pair
    collection (``collector.make_pair_collector``) and dispatches the
    per-kind reductions, returning ``resolve() -> Thresholds`` with
    ``resolve.ready()``; ``estimate`` is ``submit(...)()``, so overlapped
    and lockstep re-estimation give the same thresholds.  Float inputs are
    perturbed per row (numpy, seeded by ``seed`` and the step); token-only
    inputs get ``x + row * eps * ||x|| * d / ||d||`` at the embedding
    output, with ``d`` drawn on the device from a generator seeded by
    ``seed`` and the step (the reference draws it from ``jax.random``, so
    the directions differ between the packages)."""
    from repro_torch.core.collector import make_pair_collector

    float_keys = _float_keys(batch)
    token_mode = not float_keys

    row_rewrite = None
    if token_mode:
        def row_rewrite(row, step):
            if row == 0:
                return None

            def perturb_tap(x):
                gen = torch.Generator(device=x.device)
                gen.manual_seed(((seed ^ 0x5EED) << 20) + step)
                d = torch.randn(x.shape, generator=gen, device=x.device,
                                dtype=torch.float32)
                xf = x.float()
                nx = torch.sqrt(torch.sum(torch.square(xf)))
                nd = torch.clamp(torch.sqrt(torch.sum(torch.square(d))),
                                 min=1e-30)
                return xf + (eps * nx / nd) * d
            return {_EMB_TAP: perturb_tap}

    collect = make_pair_collector(loss_call, opt, params,
                                  row_rewrite=row_rewrite)

    def submit(p, st, live_batch: dict, step: int = 0):
        if token_mode:
            b2 = {k: torch.stack([v, v]) for k, v in live_batch.items()}
        else:
            b2 = {}
            for i, k in enumerate(live_batch):
                base = live_batch[k]
                if k in float_keys:
                    pert = perturb(to_numpy(base), eps,
                                   seed=seed + step * 131 + i)
                    pert = torch.as_tensor(pert).to(base.device)
                else:
                    pert = base
                b2[k] = torch.stack([base, pert])
        t0, t1 = collect(p, st, b2, step=step)
        pend = diff_sections_async(t0, t1)

        def resolve() -> Thresholds:
            return Thresholds(eps=eps, margin=margin, per_tensor=pend())

        resolve.ready = pend.ready
        return resolve

    def estimate(p, st, live_batch: dict, step: int = 0) -> Thresholds:
        return submit(p, st, live_batch, step=step)()

    estimate.submit = submit
    return estimate

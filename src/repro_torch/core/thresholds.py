"""Expected FP round-off estimation (paper §5): the port of
``repro/core/thresholds.py``.

The reference runs twice — on X and on X + dX with ||dX|| ~= eps * ||X|| —
and the induced relative error of every traced tensor becomes its
threshold (times a margin).  Token-input models are perturbed at the
embedding output through the rewrite mechanism.

``make_pair_estimator`` is the supervised loop's re-estimation: built
once, its ``submit`` dispatches the pair run and the reductions and
returns the estimate's resolution, so it overlaps the training steps
behind it (``diff_sections_async``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import canonical as C
from repro_torch.core import spans
from repro_torch.core.collector import Trace, to_numpy
from repro_torch.core.generator import perturb
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
    emb = "embedding/output"
    if emb not in base_trace.activations:
        raise ValueError("no float inputs and no embedding/output tap to perturb")
    x = perturb(base_trace.activations[emb], eps, seed=seed)
    tap = base_trace.activations.raw(emb)
    if isinstance(tap, torch.Tensor):
        x = torch.as_tensor(x)
        if tap.device.type != "cpu":
            spans.count("h2d_bytes", spans.nbytes(x))
        x = x.to(tap.device)
    return batch, {emb: x}


def estimate_thresholds(run_trace, batch: dict, eps: float,
                        margin: float = 8.0, seed: int = 0
                        ) -> tuple[Thresholds, Trace]:
    """``run_trace(batch, rewrites) -> Trace`` runs the REFERENCE.

    Returns (thresholds, base_reference_trace) — the base trace is reused as
    the reference side of the differential test, so threshold estimation
    costs exactly one extra iteration (paper §3 step 1).

    A runner with ``.pair`` collects the base and perturbed runs together
    when the batch has float inputs; token inputs stay serial (the
    embedding perturbation needs the base trace first).
    """
    pair = getattr(run_trace, "pair", None)
    if pair is not None and _float_keys(batch):
        with spans.span("perturb"):
            b2, _ = perturbed_batch_or_rewrites(batch, None, eps, seed)
        with spans.span("run"):
            t1, t2 = pair({k: np.stack([to_numpy(batch[k]), to_numpy(b2[k])])
                           for k in batch})
    else:
        with spans.span("run"):
            t1 = run_trace(batch, None)
        with spans.span("perturb"):
            b2, rew = perturbed_batch_or_rewrites(batch, t1, eps, seed)
        with spans.span("run"):
            t2 = run_trace(b2, rew)
    with spans.span("sections"):
        per_tensor = _diff_sections(t1, t2)
    thr = Thresholds(eps=eps, margin=margin, per_tensor=per_tensor)
    return thr, t1


# ---------------------------------------------------------------------------
# Build-once pair estimator (periodic re-estimation, paper §5 live)
# ---------------------------------------------------------------------------

_EMB_TAP = "embedding/output"


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

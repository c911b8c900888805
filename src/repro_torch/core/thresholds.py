"""Expected FP round-off estimation (paper §5): the port of the serial path
of ``repro/core/thresholds.py``.

The reference runs twice — on X and on X + dX with ||dX|| ~= eps * ||X|| —
and the induced relative error of every traced tensor becomes its
threshold (times a margin).  Token-input models are perturbed at the
embedding output through the rewrite mechanism.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import canonical as C
from repro_torch.core.collector import Trace, to_numpy
from repro_torch.core.generator import perturb
from repro_torch.core.relerr_engine import _to_rel_err, section_sq_norms

MACHINE_EPS = {
    "float32": 2.0 ** -24,
    "bfloat16": 2.0 ** -8,
    "float16": 2.0 ** -11,
    # fp8 recipes accumulate in >=bf16 (paper §6.7): thresholds are expressed
    # in bf16 epsilons, perturbations injected at bf16 magnitude.
    "float8_e4m3fn": 2.0 ** -8,
}


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


def _diff_sections(t1: Trace, t2: Trace) -> dict[str, dict[str, float]]:
    """{kind: {name: rel_err}} between two traces, one reduction per kind."""
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
    batch; token-only models are perturbed at the embedding output."""
    float_keys = _float_keys(batch)
    if float_keys:
        b2 = dict(batch)
        for i, k in enumerate(float_keys):
            b2[k] = perturb(to_numpy(batch[k]), eps, seed=seed + i)
        return b2, None
    emb = "embedding/output"
    if emb not in base_trace.activations:
        raise ValueError("no float inputs and no embedding/output tap to perturb")
    return batch, {emb: perturb(base_trace.activations[emb], eps, seed=seed)}


def estimate_thresholds(run_trace, batch: dict, eps: float,
                        margin: float = 8.0, seed: int = 0
                        ) -> tuple[Thresholds, Trace]:
    """``run_trace(batch, rewrites) -> Trace`` runs the REFERENCE.

    Returns (thresholds, base_reference_trace) — the base trace is reused as
    the reference side of the differential test, so threshold estimation
    costs exactly one extra iteration (paper §3 step 1).
    """
    t1 = run_trace(batch, None)
    b2, rew = perturbed_batch_or_rewrites(batch, t1, eps, seed)
    t2 = run_trace(b2, rew)
    thr = Thresholds(eps=eps, margin=margin, per_tensor=_diff_sections(t1, t2))
    return thr, t1

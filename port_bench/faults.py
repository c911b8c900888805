"""Faults planted under the timed path, to show that the comparison
catches them (``control.py`` on the card, ``tests/`` on the CPU).  Each
is a context manager that patches the program for the span of the block;
``run.py`` never uses them.

* ``unchanged_state``: the optimizer step returns the parameters it was
  given;
* ``half_batch``: the reference runner's loss is the mean over the first
  half of the tokens, the rest left out;
* ``no_exchange``: the emulated mesh's sums over ranks are left out, each
  rank keeping its own partial (all-reduce) or its own piece of it
  (reduce-scatter);
* ``altered_answer``: the checker's largest rel-err (over its threshold)
  is doubled where it is produced.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, attr, make):
    saved = getattr(owner, attr)
    setattr(owner, attr, make(saved))
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def unchanged_state():
    from repro_torch.optim.adamw import AdamW

    def make(update):
        def unchanged(self, params, grads, state, loss_scale=None):
            _, new_state, info = update(self, params, grads, state,
                                        loss_scale)
            return dict(params), new_state, info
        return unchanged
    return _patched(AdamW, "update", make)


def half_batch():
    from repro_torch.core import harness

    def make(inputs_on):
        def first_half(dev, batch, rewrites=None):
            b, rw = inputs_on(dev, batch, rewrites)
            mask = torch.ones(b["labels"].shape, device=dev)
            mask[..., mask.shape[-1] // 2:] = 0
            return {**b, "loss_mask": mask}, rw
        return first_half
    return _patched(harness, "inputs_on", make)


@contextlib.contextmanager
def no_exchange():
    from repro_torch.parallel.mesh import AXIS_DIM, Mesh

    def own_piece(self, x, axis, dim):
        d, n = AXIS_DIM[axis], self.sizes[axis]
        pieces = self._grid(x).chunk(n, dim=3 + dim)
        return self._flat(torch.stack([pieces[i].select(d, i)
                                       for i in range(n)], dim=d))

    with _patched(Mesh, "_psum", lambda _: lambda self, x, axes: x), \
            _patched(Mesh, "_psum_scatter", lambda _: own_piece):
        yield


def altered_answer():
    from repro_torch.core import harness

    def make(compare):
        def altered(ref, cand, thr, *a, **kw):
            rep = compare(ref, cand, thr, *a, **kw)
            if rep.records:
                worst = max(rep.records, key=lambda r: r.rel_err / r.threshold)
                worst.rel_err *= 2.0
            return rep
        return altered
    return _patched(harness, "compare_traces", make)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_answer": altered_answer}

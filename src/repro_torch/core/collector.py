"""Trace collector (paper §4.3): the port of ``repro/core/collector.py``.

One training iteration records

* forward activations of every tapped module,
* activation gradients (zero probes, see ``core.tap``),
* parameter gradients,
* main (fp32, post-clip) gradients from the optimizer,
* post-step parameters,

as a ``Trace`` whose sections keep their leaves as device tensors until
something asks for numpy (``section[name]`` or ``.host()``).  The reference
needs three passes (shape discovery, the jitted step, the optimizer); here
they are one eager forward, one backward and one optimizer step.
"""
from __future__ import annotations

from collections.abc import MutableMapping
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import canonical as C
from repro_torch.core import spans
from repro_torch.core.tap import TraceContext


def _tree_key(name: str):
    """Sort key giving the reference's pytree flattening order: dict keys
    sorted as strings, list indices as integers."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in name.split("."))


def named_params(model: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    """``model.named_parameters()`` in ``flatten_named`` order."""
    return dict(sorted(model.named_parameters(), key=lambda kv: _tree_key(kv[0])))


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a leaf; bf16 and other non-numpy floats become
    float32 (numpy has no bfloat16)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64,
                                                 torch.float16):
        x = x.float()
    if x.device.type != "cpu":
        spans.count("d2h_bytes", spans.nbytes(x))
    return x.cpu().numpy()


class Section(MutableMapping):
    """One trace kind: an ordered name -> tensor mapping with a lazy host
    boundary.  ``sec[name]`` / ``.items()`` materialize numpy (cached);
    ``.raw(name)`` / ``.raw_items()`` return the stored leaf untouched — the
    contract the batched checker relies on."""
    __slots__ = ("_data", "_host")

    def __init__(self, data=None):
        if isinstance(data, Section):
            self._data = dict(data._data)
            self._host = dict(data._host)
        else:
            self._data = dict(data) if data else {}
            self._host = {}

    def __getitem__(self, name) -> np.ndarray:
        h = self._host.get(name)
        if h is None:
            h = self._host[name] = to_numpy(self._data[name])
        return h

    def __setitem__(self, name, value):
        self._data[name] = value
        self._host.pop(name, None)

    def __delitem__(self, name):
        del self._data[name]
        self._host.pop(name, None)

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, name):
        return name in self._data

    def __repr__(self):
        return f"Section({list(self._data)!r})"

    def raw(self, name):
        """The stored leaf — no host transfer."""
        return self._data[name]

    def raw_items(self):
        return self._data.items()

    def shape_of(self, name) -> tuple:
        return tuple(self._data[name].shape)

    def host(self) -> dict[str, np.ndarray]:
        """Materialize every leaf to numpy (one explicit bulk transfer)."""
        return {name: self[name] for name in self._data}


SECTION_FIELDS = ("activations", "act_grads", "param_grads", "main_grads",
                   "params_post")


@dataclass
class Trace:
    activations: Section = field(default_factory=Section)
    act_grads: Section = field(default_factory=Section)
    param_grads: Section = field(default_factory=Section)
    main_grads: Section = field(default_factory=Section)
    params_post: Section = field(default_factory=Section)
    loss: float = float("nan")
    grad_norm: float = float("nan")
    meta: dict = field(default_factory=dict)

    def __setattr__(self, name, value):
        # plain dicts are adopted into lazy Sections
        if name in SECTION_FIELDS and not isinstance(value, Section):
            value = Section(value)
        object.__setattr__(self, name, value)

    def section(self, kind: str) -> Section:
        return {C.KIND_ACT: self.activations, C.KIND_ACT_GRAD: self.act_grads,
                C.KIND_PARAM_GRAD: self.param_grads,
                C.KIND_MAIN_GRAD: self.main_grads,
                C.KIND_PARAM_POST: self.params_post}[kind]


def trace_train_step(model, batch, opt=None, opt_state=None,
                     rewrites: Optional[dict] = None
                     ) -> tuple[Trace, dict, Optional[dict]]:
    """Run ONE training iteration of the single-device reference with full
    trace collection.  Returns (trace, new_params, new_opt_state); the
    model's own parameters are not changed.

    ``rewrites``: {tap_name: array} — overwrite module inputs
    (localization mode / threshold estimation).
    """
    def loss_call(b, ctx):
        loss, _ = model.loss(b, ctx=ctx)
        return loss

    return trace_fn_step(loss_call, named_params(model), batch, opt=opt,
                         opt_state=opt_state, rewrites=rewrites)


def _grad(t: torch.Tensor) -> torch.Tensor:
    # a leaf off the differentiation path has a zero gradient, as in jax.grad
    return t.grad if t.grad is not None else torch.zeros_like(t)


def load_params(params: dict, values: dict) -> None:
    """Copy ``values`` into the ``{name: Parameter}`` leaves ``params``."""
    with torch.no_grad():
        for k, leaf in params.items():
            leaf.copy_(values[k])


def _collect(loss_call, params: dict, batch, rewrites=None) -> Trace:
    """Forward and backward of ``loss_call`` with every tap and probe; the
    trace's loss stays a device tensor (nothing here waits for the
    device)."""
    ctx = TraceContext("rewrite" if rewrites else "collect",
                       rewrites=rewrites, probes=True)
    for p in params.values():
        p.grad = None
    loss = loss_call(batch, ctx)
    loss.backward()
    fwd_order = list(ctx.fwd)
    probes = ctx.probes

    tr = Trace()
    tr.loss = loss.detach()
    tr.activations = ctx.fwd
    tr.act_grads = {k: _grad(probes[k]) for k in fwd_order if k in probes}
    tr.param_grads = {k: _grad(p) for k, p in params.items()}
    tr.meta["fwd_order"] = fwd_order
    for p in params.values():
        p.grad = None
    return tr


def _optimizer_sections(tr: Trace, opt, values: dict, opt_state):
    """Apply ``opt`` to ``values`` with the trace's gradients and record the
    main gradients and post-step parameters; grad norm stays a tensor."""
    new_params, new_state, info = opt.update(
        values, dict(tr.param_grads.raw_items()), opt_state)
    tr.main_grads = info.main_grads
    tr.params_post = new_params
    tr.grad_norm = info.grad_norm
    return new_params, new_state


def trace_fn_step(loss_call, params: dict, batch, opt=None, opt_state=None,
                  rewrites=None) -> tuple[Trace, dict, Optional[dict]]:
    """Generic collector over any ``loss_call(batch, ctx) -> loss`` whose
    parameters are ``params`` (``{flat name: Parameter}``)."""
    tr = _collect(loss_call, params, batch, rewrites)
    tr.loss = float(tr.loss)
    new_params, new_state = params, opt_state
    if opt is not None:
        values = {k: p.detach() for k, p in params.items()}
        if opt_state is None:
            opt_state = opt.init(values)
        new_params, new_state = _optimizer_sections(tr, opt, values,
                                                    opt_state)
        tr.grad_norm = float(tr.grad_norm)
    return tr, new_params, new_state


# ---------------------------------------------------------------------------
# Stateful trace step (the supervisor's lockstep contract)
# ---------------------------------------------------------------------------

def make_trace_step(loss_call, opt, params: dict):
    """A trace-collecting FULL train step over state threaded by the caller.

    ``params`` are the ``{name: Parameter}`` leaves ``loss_call(batch, ctx)``
    reads.  Returns ``step(p, opt_state, batch) -> (Trace, new_p,
    new_opt_state)``: ``p`` is copied into the leaves, the step runs
    forward, backward and ``opt.update(p, ...)``.  Nothing is updated in
    place — the returned state and every trace leaf are new tensors — and
    ``trace.loss`` / ``trace.grad_norm`` stay device tensors, so the caller
    never has to wait for the device."""
    def step(p: dict, st: dict, batch):
        load_params(params, p)
        tr = _collect(loss_call, params, batch)
        new_p, new_st = _optimizer_sections(tr, opt, p, st)
        return tr, new_p, new_st

    return step


# ---------------------------------------------------------------------------
# Pair collector (threshold estimation: base and perturbed runs)
# ---------------------------------------------------------------------------

def make_pair_collector(loss_call, opt, params: dict, row_rewrite=None):
    """Build-once BASE+PERTURBED pair collection.

    Returns ``collect(p, opt_state, batch2, step=0) -> (Trace, Trace)``:
    ``batch2`` stacks the two rows' batches on a leading axis of 2.  The
    reference ``vmap``s the rows; here they run one after the other on
    the same state (never as one batch of 2B, whose mean loss would mix
    the rows' gradients).  ``row_rewrite(row, step)`` optionally gives a
    row's callable rewrites (the token-input embedding perturbation, a
    no-op on row 0).  Losses and grad norms stay device tensors."""
    def collect(p: dict, st, batch2: dict, step: int = 0):
        load_params(params, p)
        traces = []
        for row in (0, 1):
            b = {k: v[row] for k, v in batch2.items()}
            rew = row_rewrite(row, step) if row_rewrite is not None else None
            tr = _collect(loss_call, params, b, rew)
            if opt is not None:
                _optimizer_sections(tr, opt, p, st)
            traces.append(tr)
        return traces[0], traces[1]

    return collect


def trace_fn_pair(loss_call, params: dict, batch2: dict, opt=None,
                  opt_state=None) -> tuple[Trace, Trace]:
    """Traces of the two rows of ``batch2`` (one-shot: host-float losses)."""
    values = {k: p.detach() for k, p in params.items()}
    st = None
    if opt is not None:
        st = opt_state if opt_state is not None else opt.init(values)
    t0, t1 = make_pair_collector(loss_call, opt, params)(values, st, batch2)
    for tr in (t0, t1):
        tr.loss = float(tr.loss)
        if opt is not None:
            tr.grad_norm = float(tr.grad_norm)
    return t0, t1


def trace_pair_step(model, batch2: dict, opt=None, opt_state=None
                    ) -> tuple[Trace, Trace]:
    """``trace_fn_pair`` over a port ``Model``'s own parameters."""
    def loss_call(b, ctx):
        return model.loss(b, ctx=ctx)[0]

    return trace_fn_pair(loss_call, named_params(model), batch2, opt=opt,
                         opt_state=opt_state)

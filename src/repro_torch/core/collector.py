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


def trace_fn_step(loss_call, params: dict, batch, opt=None, opt_state=None,
                  rewrites=None) -> tuple[Trace, dict, Optional[dict]]:
    """Generic collector over any ``loss_call(batch, ctx) -> loss`` whose
    parameters are ``params`` (``{flat name: Parameter}``)."""
    ctx = TraceContext("rewrite" if rewrites else "collect",
                       rewrites=rewrites, probes=True)
    for p in params.values():
        p.grad = None
    loss = loss_call(batch, ctx)
    loss.backward()
    fwd_order = list(ctx.fwd)
    probes = ctx.probes

    tr = Trace()
    tr.loss = float(loss.detach())
    tr.activations = ctx.fwd
    tr.act_grads = {k: _grad(probes[k]) for k in fwd_order if k in probes}
    tr.param_grads = {k: _grad(p) for k, p in params.items()}
    tr.meta["fwd_order"] = fwd_order
    for p in params.values():
        p.grad = None

    new_params, new_state = params, opt_state
    if opt is not None:
        values = {k: p.detach() for k, p in params.items()}
        if opt_state is None:
            opt_state = opt.init(values)
        new_params, new_state, info = opt.update(
            values, dict(tr.param_grads.raw_items()), opt_state)
        tr.main_grads = info.main_grads
        tr.params_post = new_params
        tr.grad_norm = float(info.grad_norm)
    return tr, new_params, new_state

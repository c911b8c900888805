"""Trace taps: the port of ``repro/core/tap.py``.

Every module calls ``ctx.tap(role, x)`` on the tensors TTrace traces
(paper §4.3).  In **collect** mode the tapped value is recorded; in
**rewrite** mode (paper §3 step 5) it is first replaced by
``rewrites[name]``.  Activation gradients use the reference's zero probes:
the tap returns ``x + probe.to(x.dtype)`` for an fp32 zeros probe that
requires grad, so after ``backward()`` the probe's ``.grad`` is the
gradient w.r.t. the tapped activation.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch


class TraceContext:
    """Threaded through a model's forward; records / rewrites tapped tensors.

    modes:
      "off"      — taps are identity
      "collect"  — record forward values
      "rewrite"  — overwrite tapped tensors with ``rewrites[name]`` AND record

    ``probes=True`` attaches a zero probe to every floating tap;
    ``self.probes[name].grad`` then holds its gradient.
    """

    def __init__(self, mode: str = "collect", rewrites: Optional[dict] = None,
                 probes: bool = False):
        if mode not in ("off", "collect", "rewrite"):
            raise ValueError(f"unknown tap mode {mode!r}")
        self.mode = mode
        self.rewrites = rewrites or {}
        self.probes: Optional[dict[str, torch.Tensor]] = {} if probes else None
        self.fwd: dict[str, torch.Tensor] = {}
        self._prefix: list[str] = []

    @contextmanager
    def scope(self, name: str):
        self._prefix.append(name)
        try:
            yield self
        finally:
            self._prefix.pop()

    def path(self, role: str = "") -> str:
        p = ".".join(self._prefix)
        if not role:
            return p
        return f"{p}/{role}" if p else role

    def tap(self, role: str, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "off":
            return x
        name = self.path(role)
        if self.mode == "rewrite" and name in self.rewrites:
            # straight-through overwrite: the VALUE becomes the rewrite while
            # gradients still flow through the original tensor
            rw = self.rewrites[name]
            r = rw(x) if callable(rw) else rw
            r = torch.as_tensor(r, device=x.device).to(x.dtype)
            x = x + (r - x).detach()
        if name in self.fwd:
            raise ValueError(
                f"duplicate canonical tensor identifier {name!r} in one trace")
        self.fwd[name] = x.detach()
        if self.probes is not None and x.is_floating_point():
            probe = torch.zeros(x.shape, dtype=torch.float32, device=x.device,
                                requires_grad=True)
            self.probes[name] = probe
            x = x + probe.to(x.dtype)
        return x


NULL_CTX = TraceContext(mode="off")


def ensure_ctx(ctx: Optional[TraceContext]) -> TraceContext:
    return NULL_CTX if ctx is None else ctx

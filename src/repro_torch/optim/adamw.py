"""AdamW with fp32 master weights and main gradients: the port of
``repro/optim/adamw.py``.

``update`` is functional over ``{name: tensor}`` dicts, as the reference is
over its pytree: the model's parameters are left untouched, so one runner
can replay the same step (threshold estimation, localization).  It returns
an ``OptInfo`` carrying the fp32 post-clip **main gradients** TTrace
traces right before the step.

``lr`` is a float or a callable of the step count (``warmup_cosine``).
The step count stays a Python int and every scalar the update needs is
made on the parameters' device, so an update never waits for the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> Callable[[int], float]:
    """Linear warmup over ``warmup`` steps, then cosine decay to
    ``min_ratio * base_lr`` at ``total`` (the reference's schedule)."""
    def lr(step) -> float:
        step = float(step)
        w = min(1.0, (step + 1) / max(warmup, 1))
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog))
        return base_lr * w * cos
    return lr


@dataclass
class OptInfo:
    main_grads: dict      # fp32 grads after clipping — TTrace "main gradients"
    grad_norm: torch.Tensor
    lr: float = 0.0
    loss_scale: float = 1.0


@dataclass
class AdamW:
    lr: float | Callable[[int], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip: float = 1.0
    # parameters whose leaf name matches any of these skip weight decay
    no_decay_suffixes: tuple = ("norm", "b", "bias", "mu", "u", "w0", "D",
                                "A_log", "dt_bias", "mu_x", "mu_k", "mu_r")

    def init(self, params: dict) -> dict:
        return {"master": {k: p.detach().float().clone() for k, p in params.items()},
                "m": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32)
                      for k, p in params.items()},
                "step": 0}

    def decays(self, name: str) -> bool:
        """The reference's decay mask, keyed by the flat name's leaf."""
        last = name.rsplit(".", 1)[-1]
        return not any(last == s or last.endswith("_norm") or
                       last.startswith("mu") or last in ("b",)
                       for s in self.no_decay_suffixes)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               loss_scale: Optional[float] = None):
        step = state["step"] + 1
        lr = self.lr(state["step"]) if callable(self.lr) else self.lr
        main = {k: g.float() for k, g in grads.items()}
        if loss_scale is not None:
            main = {k: g / loss_scale for k, g in main.items()}
        pre_norm = global_norm(main.values())
        if self.clip:
            scale = torch.clamp(self.clip / torch.clamp(pre_norm, min=1e-12),
                                max=1.0)
            main = {k: g * scale for k, g in main.items()}
        gnorm = global_norm(main.values())

        b1, b2 = self.b1, self.b2
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        # torch.full, not torch.tensor: no host-to-device copy, no wait
        bc1 = 1 - torch.full((), b1, **f32) ** step
        bc2 = 1 - torch.full((), b2, **f32) ** step
        master, m, v = {}, {}, {}
        for k, g in main.items():
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g * g
            u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + self.eps)
            if self.weight_decay and self.decays(k):
                u = u + self.weight_decay * state["master"][k]
            master[k] = state["master"][k] - lr * u
        new_params = {k: master[k].to(p.dtype) for k, p in params.items()}
        new_state = {"master": master, "m": m, "v": v, "step": step}
        return new_params, new_state, OptInfo(
            main_grads=main, grad_norm=gnorm, lr=lr,
            loss_scale=1.0 if loss_scale is None else loss_scale)

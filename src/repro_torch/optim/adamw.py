"""AdamW with fp32 master weights and main gradients: the port of
``repro/optim/adamw.py``.

``update`` is functional over ``{name: tensor}`` dicts, as the reference is
over its pytree: the model's parameters are left untouched, so one runner
can replay the same step (threshold estimation, localization).  It returns
an ``OptInfo`` carrying the fp32 post-clip **main gradients** TTrace
traces right before the step.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@dataclass
class OptInfo:
    main_grads: dict      # fp32 grads after clipping — TTrace "main gradients"
    grad_norm: torch.Tensor


@dataclass
class AdamW:
    lr: float = 1e-3
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
    def update(self, params: dict, grads: dict, state: dict):
        step = state["step"] + 1
        main = {k: g.float() for k, g in grads.items()}
        pre_norm = global_norm(main.values())
        if self.clip:
            scale = torch.clamp(self.clip / torch.clamp(pre_norm, min=1e-12),
                                max=1.0)
            main = {k: g * scale for k, g in main.items()}
        gnorm = global_norm(main.values())

        b1, b2 = self.b1, self.b2
        f32 = dict(dtype=torch.float32, device=gnorm.device)
        bc1 = 1 - torch.tensor(b1, **f32) ** step
        bc2 = 1 - torch.tensor(b2, **f32) ** step
        master, m, v = {}, {}, {}
        for k, g in main.items():
            m[k] = b1 * state["m"][k] + (1 - b1) * g
            v[k] = b2 * state["v"][k] + (1 - b2) * g * g
            u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + self.eps)
            if self.weight_decay and self.decays(k):
                u = u + self.weight_decay * state["master"][k]
            master[k] = state["master"][k] - self.lr * u
        new_params = {k: master[k].to(p.dtype) for k, p in params.items()}
        new_state = {"master": master, "m": m, "v": v, "step": step}
        return new_params, new_state, OptInfo(main_grads=main, grad_norm=gnorm)

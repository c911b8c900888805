"""Step functions and input specs for training, prefill and decode: the port
of ``repro/launch/steps.py``.

``input_specs`` and ``cache_specs`` give shape-and-dtype stand-ins for
the step functions' inputs as tensors on the ``meta`` device: nothing is
allocated.  Token ids and labels are ``int64``, the dtype the port's
``data/synthetic.make_batch`` gives them and its embedding indexes with,
where the reference's are ``int32``.

The steps are functional over ``{flat name: tensor}`` parameters, as the
reference's are over its pytree: a step copies them into the model's own
leaves, runs, and returns new tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.collector import load_params, named_params
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW


def spec(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for the step function's data inputs."""
    B, S = shape.global_batch, shape.seq_len
    ids, f32 = torch.int64, torch.float32
    if shape.kind in ("train", "prefill"):
        if cfg.arch_type == "audio":
            return {"features": spec((B, S, cfg.audio_dim), f32),
                    "mask": spec((B, S), torch.bool),
                    "labels": spec((B, S), ids)}
        if cfg.arch_type == "vlm":
            n_img = min(cfg.n_image_tokens, S - 16)
            return {"tokens": spec((B, S - n_img), ids),
                    "labels": spec((B, S - n_img), ids),
                    "image_embeds": spec((B, n_img, cfg.vision_dim), f32)}
        return {"tokens": spec((B, S), ids), "labels": spec((B, S), ids)}
    # decode: one new token against a seq_len cache
    return {"tokens": spec((B, 1), ids), "pos": spec((), ids)}


def cache_specs(model: Model, shape: InputShape) -> dict:
    """Stand-ins for ``model.init_cache(global_batch, seq_len)``: the same
    tree, shapes and dtypes, on the meta device."""
    return model.init_cache(shape.global_batch, shape.seq_len, device="meta")


def make_train_step(model: Model, opt: AdamW, n_micro: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with gradient accumulation over ``n_micro`` microbatches.

    ``params`` (``{flat name: tensor}``) are copied into the model's
    leaves; forward, backward and ``opt.update`` follow, and the returned
    state is new tensors (``collector.make_trace_step``'s contract,
    without the trace).  At ``n_micro == 1`` the gradients reach the
    optimizer as autograd gives them (bf16 for bf16 parameters).  Above
    it, every batch leaf is split along dim 0 into ``n_micro`` contiguous
    microbatches, the gradients are summed in f32 from zeros in
    microbatch order and divided by ``n_micro``, and ``loss`` and each
    metric are the mean over microbatches.  ``metrics`` holds ``loss``,
    ``grad_norm``, ``lr``, ``ce`` and ``aux``; the tensors among them stay
    on the device.

    The reference's ``_constrain_opt_like`` (a sharding constraint on the
    f32 accumulator) does nothing without a sharding context, and the
    port has none on one card: it has no counterpart."""
    leaves = named_params(model)

    def grads_of(batch):
        for p in leaves.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in leaves.items()}
        for p in leaves.values():
            p.grad = None
        return grads, {"loss": loss.detach(),
                       **{k: v.detach() for k, v in metrics.items()}}

    def train_step(params: dict, opt_state: dict, batch: dict):
        load_params(leaves, params)
        if n_micro == 1:
            grads, metrics = grads_of(batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} does not split into {n_micro} "
                                 f"microbatches")
            mb = B // n_micro
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in leaves.items()}
            per_micro = []
            for i in range(n_micro):
                g, m = grads_of({k: v[i * mb:(i + 1) * mb]
                                 for k, v in batch.items()})
                for k, gk in g.items():
                    grads[k].add_(gk)
                per_micro.append(m)
                del g
            for g in grads.values():
                g.div_(n_micro)
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        new_params, new_state, info = opt.update(params, grads, opt_state)
        loss = metrics.pop("loss")
        return new_params, new_state, {"loss": loss,
                                       "grad_norm": info.grad_norm,
                                       "lr": info.lr, **metrics}

    return train_step


def default_n_micro(cfg: ArchConfig, shape: InputShape, dp_total: int,
                    act_budget_bytes: int = 5 << 30) -> int:
    """Pick a microbatch count so per-device layer-boundary saves
    (L * S * d_model * 2B * B_micro_local) fit the activation budget.

    Where even one sequence a microbatch is over the budget, the answer
    is the local batch: the reference's search for a divisor never ends
    there."""
    if shape.kind != "train":
        return 1
    b_local = max(1, shape.global_batch // dp_total)
    per_seq = cfg.n_layers * shape.seq_len * cfg.d_model * 2
    want = max(1, math.ceil(b_local * per_seq / act_budget_bytes))
    while want < b_local and b_local % want:
        want += 1
    return min(want, b_local)


def make_prefill_step(model: Model):
    """``prefill_step(batch)``: the last position's logits (B, 1, vocab),
    the serving prefill contract, so the (B, S, vocab) logits never
    materialize."""
    @torch.no_grad()
    def prefill_step(batch):
        h = model.forward(batch)
        return model.unembed(h[:, -1:])
    return prefill_step


def make_serve_step(model: Model):
    """``serve_step(cache, batch)`` -> (logits, cache): one decode step of
    ``batch["tokens"]`` (B, 1) at ``batch["pos"]``."""
    def serve_step(cache, batch):
        return model.decode_step(cache, batch["tokens"], batch["pos"])
    return serve_step

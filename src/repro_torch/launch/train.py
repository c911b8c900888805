"""End-to-end training driver: the port of ``repro/launch/train.py``, with
the same flags plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 50 --batch 8 --seq 128 --ttrace-every 0 \
        [--device cpu]

Deterministic data pipeline -> model -> AdamW (fp32 masters) ->
checkpointing, with an optional TTrace check: ``--ttrace-every N`` runs
the paper's one-iteration differential check of the step's new state
against itself every N steps (the "integrated into the testing pipeline"
regression mode of §8).  On the card ``main`` turns on deterministic
mode first (``launch.supervise.deterministic_mode``).

A ``--resume`` from a checkpoint at or past ``--steps`` is refused: the
reference runs no step then and fails on its empty loss list.  As in the
reference, the lr schedule spans ``--steps``, so a run resumed with
another ``--steps`` does not repeat an uninterrupted one.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.core.collector import load_params, named_params
from repro_torch.core.harness import make_model_runner, ttrace_check
from repro_torch.core.spans import STEPS
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW, warmup_cosine


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-scale) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="checkpoint dir")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ttrace-every", type=int, default=0,
                    help="run a TTrace differential check every N steps")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def check_line(res) -> str:
    """A check's step seconds and, on the card, each step's allocator
    retries (each one frees the allocator's cache)."""
    steps = ", ".join(f"{k} {res.seconds[k]:.3f} s" for k in STEPS
                      if k in res.seconds)
    retries = [f"{k} {res.counts[k + '.alloc_retries']}" for k in STEPS
               if k + ".alloc_retries" in res.counts]
    return steps + (f"; alloc retries {', '.join(retries)}" if retries
                    else "")


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and torch.cuda.is_available():
        from repro_torch.launch.supervise import deterministic_mode
        deterministic_mode()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, seed=args.seed, device=dev)
    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps))

    params = {k: p.detach().clone() for k, p in named_params(model).items()}
    opt_state = opt.init(params)
    start_step = 0
    if args.resume:
        (params, opt_state), start_step, _ = load_checkpoint(
            args.resume, (params, opt_state))
        print(f"resumed from {args.resume} at step {start_step}")
        if start_step >= args.steps:
            raise SystemExit(f"nothing to train: {args.resume} is at step "
                             f"{start_step}, --steps is {args.steps}")

    n_params = sum(p.numel() for p in params.values())
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} ({'reduced' if args.reduced else 'full'}) "
          f"params={n_params/1e6:.1f}M devices={n_dev}")

    step_fn = make_train_step(model, opt, n_micro=args.n_micro)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = make_batch(cfg, args.batch, args.seq, seed=args.seed,
                           step=step, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)")
        if args.ttrace_every and step and step % args.ttrace_every == 0:
            load_params(named_params(model), params)
            ref = make_model_runner(model, opt, opt_state, device=dev)
            cand = make_model_runner(model, opt, opt_state, device=dev)
            res = ttrace_check(ref, cand, batch, localize=False)
            print(f"  [ttrace] regression check: "
                  f"{'PASS' if res.passed else 'FAIL'} ({check_line(res)})")
            del ref, cand, res      # the two traces: free them for training
    if args.save:
        save_checkpoint(args.save, (params, opt_state), step=args.steps)
        print("saved to", args.save)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()

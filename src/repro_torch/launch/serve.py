"""Batched serving CLI: prefill + decode with KV/state caches; the port
of ``repro/launch/serve.py``, with the same flags plus ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Prefill steps the decode path over the prompt (cache-exact), then
``--gen`` tokens are decoded: greedy at ``--temperature 0``, else sampled
from a ``torch.Generator`` seeded from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompt, gen: int, temperature: float = 0.0,
             generator=None):
    """Decode ``gen`` tokens after ``prompt`` (B, P).  Returns (tokens (B,
    gen), prefill seconds, decode seconds).  As in the reference, the token
    fed at each step is the previous step's argmax, or at ``temperature >
    0`` a sample of the current logits / temperature drawn with
    ``generator`` (on the model's device)."""
    dev = model.device
    prompt = prompt.to(dev)
    B, P = prompt.shape
    cache = model.init_cache(B, P + gen)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = model.decode_step(cache, prompt[:, t:t + 1], t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    last = torch.argmax(logits[:, 0], -1)[:, None]
    for t in range(P, P + gen):
        if temperature > 0:
            probs = torch.softmax(logits[:, 0].float() / temperature, -1)
            last = torch.multinomial(probs, 1, generator=generator)
        logits, cache = model.decode_step(cache, last, t)
        toks.append(last)
        last = torch.argmax(logits[:, 0], -1)[:, None]
    _sync(dev)
    return torch.cat(toks, dim=1), t_prefill, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_decoder:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode step")
    dev = resolve_device(args.device)
    model = Model(cfg, seed=args.seed, device=dev)
    B, P = args.batch, args.prompt_len
    prompt = make_batch(cfg, B, P, seed=args.seed, device=dev)["tokens"]
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    out, t_prefill, t_dec = generate(model, prompt, args.gen,
                                     args.temperature, generator)
    print(f"arch={cfg.name} prefill {P} toks in {t_prefill:.2f}s | "
          f"decoded {args.gen} toks/seq x {B} seqs in {t_dec:.2f}s "
          f"({B * args.gen / max(t_dec, 1e-9):.1f} tok/s)")
    print("generated token ids (seq 0):", [int(x) for x in out[0]])
    return out


if __name__ == "__main__":
    main()

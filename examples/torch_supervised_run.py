"""Catch an update-path bug mid-run that the single-step check misses, on
the PyTorch port.

The counterpart of ``examples/supervised_run.py``: ``zero_skipped_update``
(paper bug 9) leaves the last ZeRO-1 partition of every parameter at its
pre-update value.  At a fine-tuning learning rate one step's missing
update sits below the floating-point threshold, so the paper's
one-iteration check passes; the skipped partition falls further behind
every step while round-off does not accumulate, so the supervisor's online
checks flag the drift a few steps in and bisection names the first step it
became distinguishable from floating point.

    PYTHONPATH=src python examples/torch_supervised_run.py [steps] \\
        [--device cuda|cpu]

On the CPU the configuration is the JAX example's (reduced ``gpt-paper``,
2 layers, vocab 512, B 4 x S 32, lr 1e-7, f32 thresholds).  On the card it
is ``chip_smoke.py``'s phase 20d: ``gpt-paper`` at its published width
(d_model 512, vocab 50304) cut to 4 layers, B 8 x S 1024, in deterministic
mode, at lr 1e-3: its bf16 compute takes bf16 thresholds, whose floor
(8 x 4 x 2^-8 of a tensor's norm) a skipped update at lr 1e-7 never
reaches.
"""
import argparse
import dataclasses

BUG = "zero_skipped_update"
# (layers, vocab, batch, seq, lr) of each device's configuration
SETUPS = {"cpu": (2, 512, 4, 32, 1e-7),
          "cuda": (4, None, 8, 1024, 1e-3)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=sorted(SETUPS))
    args = ap.parse_args()

    from repro_torch.launch.supervise import deterministic_mode
    if args.device == "cuda":
        deterministic_mode()
    from repro_torch.bugs.registry import BUGS
    from repro_torch.configs.base import get_config
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import ParallelConfig, make_candidate_runner
    from repro_torch.supervise import SuperviseConfig, Supervisor

    layers, vocab, B, S, lr = SETUPS[args.device]
    cfg = get_config("gpt-paper")
    if args.device == "cpu":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=layers, vocab=vocab or cfg.vocab,
                              tie_embeddings=True)
    spec = BUGS[BUG]
    print(f"injected: {BUG} [{spec.btype}] — {spec.description}")
    print(f"gpt-paper d_model {cfg.d_model}, {layers} layers, vocab "
          f"{cfg.vocab}, B {B} x S {S} on {args.device}; lr={lr:.0e}: a "
          f"single step's missing update is below the round-off threshold\n")

    pcfg = ParallelConfig(dp=2, tp=2, zero1=True, bugs=frozenset([BUG]))
    model = Model(cfg, seed=0, device=args.device)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}

    # --- the paper's single-step check: blind at this learning rate -------
    opt = AdamW(lr=lr)
    one = ttrace_check(
        make_model_runner(model, opt, device=args.device),
        make_candidate_runner(cfg, pcfg, model, opt, device=args.device),
        make_batch(cfg, B, S, seed=0, device=args.device), localize=False)
    print(f"single-step ttrace_check: {'PASS' if one.passed else 'FAIL'} "
          f"({len(one.report.flagged)} tensors flagged) "
          f"{'— the bug slips through' if one.passed else ''}")

    # --- the streaming supervisor: drift accumulates, noise does not ------
    sup = Supervisor(model, cfg, pcfg, AdamW(lr=lr), params=params,
                     scfg=SuperviseConfig(steps=args.steps, check_every=2,
                                          ckpt_every=4),
                     batch_size=B, seq_len=S, log_fn=print,
                     device=args.device)
    res = sup.run()
    print()
    print(res.summary())
    if res.flagged:
        print(f"\nthe one-shot check said PASS; supervising {res.steps_run} "
              f"steps caught the drift at step {res.first_flagged_step} and "
              f"bisected the first bad step to {res.first_bad_step} "
              f"(localized: {res.localized_module})")


if __name__ == "__main__":
    main()

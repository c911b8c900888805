"""Quickstart on the PyTorch port: train a small model end to end, then
verify the training step with TTrace (the reference runner against
itself must be equivalent).

The counterpart of ``examples/quickstart.py``: reduced ``tinyllama-1.1b``,
20 steps of ``launch.steps.make_train_step`` at B 8 x S 64, then one
``ttrace_check`` of the trained state.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""
import argparse


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.launch.supervise import deterministic_mode
    if args.device == "cuda":
        deterministic_mode()
    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import load_params, named_params
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    cfg = get_config("tinyllama-1.1b").reduced()
    model = Model(cfg, seed=0, device=args.device)
    leaves = named_params(model)
    params = {k: p.detach().clone() for k, p in leaves.items()}
    opt = AdamW(lr=3e-4)
    state = opt.init(params)
    step = make_train_step(model, opt)

    print(f"training reduced {cfg.name} "
          f"({sum(p.numel() for p in params.values())/1e6:.1f}M params)")
    for i in range(20):
        batch = make_batch(cfg, 8, 64, step=i, device=args.device)
        params, state, metrics = step(params, state, batch)
        if i % 5 == 0:
            print(f"  step {i}: loss {float(metrics['loss']):.4f}")

    # TTrace: one-iteration differential check (paper §3)
    load_params(leaves, params)
    ref = make_model_runner(model, opt, state, device=args.device)
    cand = make_model_runner(model, opt, state, device=args.device)
    result = ttrace_check(ref, cand, make_batch(cfg, 8, 64, device=args.device),
                          localize=False)
    print("\nTTrace check (candidate == reference):",
          "PASS" if result.passed else "FAIL")
    print(f"  {len(result.report.records)} tensors compared, "
          f"{len(result.report.flagged)} flagged")


if __name__ == "__main__":
    main()

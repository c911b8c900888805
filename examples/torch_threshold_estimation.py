"""Paper §5 / Fig 7 on the PyTorch port: estimate the expected FP round-off
thresholds of a model by running the reference twice with an
epsilon-perturbed input, and print the per-layer error-accumulation curve
(normalized by machine eps).

The counterpart of ``examples/threshold_estimation.py``: the reduced
config at 8 layers and bf16 compute, B 2 x S 64.

    PYTHONPATH=src python examples/torch_threshold_estimation.py [arch] \\
        [--device cuda|cpu]
"""
import argparse
import dataclasses


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="gpt-paper")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.launch.supervise import deterministic_mode
    if args.device == "cuda":
        deterministic_mode()
    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import named_params
    from repro_torch.core.harness import make_model_runner
    from repro_torch.core.thresholds import MACHINE_EPS, estimate_thresholds
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(get_config(args.arch).reduced(), n_layers=8,
                              compute_dtype="bfloat16")
    eps = MACHINE_EPS["bfloat16"]
    model = Model(cfg, seed=0, device=args.device)
    opt = AdamW(lr=1e-3)
    params = {k: p.detach() for k, p in named_params(model).items()}
    runner = make_model_runner(model, opt, opt.init(params),
                               device=args.device)
    batch = make_batch(cfg, 2, 64, device=args.device)

    thr, base = estimate_thresholds(runner, batch, eps)
    print(f"arch={cfg.name} (reduced, 8 layers, bf16) — estimated FP "
          f"round-off error per tensor, in units of bf16 eps ({eps:.2e}):\n")
    print(f"{'tensor':48s} {'act':>8s} {'act_grad':>9s}")
    for name in base.meta["fwd_order"]:
        a = thr.per_tensor["activation"].get(name)
        g = thr.per_tensor["act_grad"].get(name)
        if a is None:
            continue
        print(f"{name:48s} {a/eps:8.2f} {(g or 0)/eps:9.2f}")
    print("\nthe slow growth with depth is the smoothness property "
          "(paper Thm 5.1/5.2) that makes thresholding work.")


if __name__ == "__main__":
    main()

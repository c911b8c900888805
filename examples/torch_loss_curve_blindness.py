"""Paper Fig 1 on the PyTorch port: loss curves are blind to silent bugs.

The counterpart of ``examples/loss_curve_blindness.py``: trains the
single-device reference (``launch.steps.make_train_step``) and the
distributed candidate (dp 2, tp 2, ranks emulated in one process;
``parallel.api.make_plain_train_step``) with an injected wrong loss
scaling side by side.  The loss curves stay within a few percent, while
a single TTrace iteration flags the bug at once, and the streaming
supervisor, riding along the same run, names the step.

    PYTHONPATH=src python examples/torch_loss_curve_blindness.py [steps] \\
        [--device cuda|cpu]
"""
import argparse
import dataclasses
import time

BUG = "dp_wrong_loss_scale"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=120)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    STEPS = args.steps

    from repro_torch.launch.supervise import deterministic_mode
    if args.device == "cuda":
        deterministic_mode()
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import load_params, named_params
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import (ParallelConfig,
                                          make_candidate_runner,
                                          make_plain_train_step)
    from repro_torch.supervise import SuperviseConfig, Supervisor

    dev = args.device
    cfg = dataclasses.replace(get_config("gpt-paper").reduced(),
                              n_layers=2, vocab=512, tie_embeddings=True)
    model = Model(cfg, seed=0, device=dev)
    leaves = named_params(model)
    params = {k: p.detach().clone() for k, p in leaves.items()}
    opt = AdamW(lr=3e-3)
    pcfg = ParallelConfig(dp=2, tp=2, bugs=frozenset([BUG]))

    ref_step = make_train_step(model, opt)
    cand_step, prep, cparams, cstate = make_plain_train_step(
        cfg, pcfg, params, opt, device=dev)
    rp, rs = params, opt.init(params)
    print("step | ref loss | buggy-candidate loss | rel gap")
    rh, ch = [], []
    for step in range(STEPS):
        batch = make_batch(cfg, 4, 32, step=step, device=dev)
        rp, rs, met = ref_step(rp, rs, batch)
        cparams, cstate, closs = cand_step(cparams, cstate, prep(batch))
        rh.append(float(met["loss"]))
        ch.append(float(closs))
        if step % 20 == 0 or step == STEPS - 1:
            w = min(20, len(rh))
            gap = abs(np.mean(ch[-w:]) - np.mean(rh[-w:])) / np.mean(rh[-w:])
            print(f"{step:4d} | {rh[-1]:.4f}  | {ch[-1]:.4f}              "
                  f"| {gap*100:.2f}%")

    w = 20
    gap = abs(np.mean(ch[-w:]) - np.mean(rh[-w:])) / np.mean(rh[-w:])
    print(f"\nafter {STEPS} steps the smoothed loss gap is {gap*100:.2f}% — "
          f"{'would NOT' if gap < 0.03 else 'would'} trip a 3% alarm.")

    # the check starts from the initial state, as the training run did
    load_params(leaves, params)
    t0 = time.time()
    res = ttrace_check(make_model_runner(model, opt, opt.init(params),
                                         device=dev),
                       make_candidate_runner(cfg, pcfg, params, opt,
                                             opt.init(params), device=dev),
                       make_batch(cfg, 4, 32, device=dev), localize=False)
    print(f"TTrace: ONE iteration in {time.time()-t0:.1f}s -> "
          f"{'detected the bug' if not res.passed else 'no bug?!'} "
          f"({len(res.report.flagged)} tensors flagged)")

    # the streaming supervisor rides along with the SAME run and names the
    # step
    t0 = time.time()
    sup = Supervisor(model, cfg, pcfg, AdamW(lr=3e-3), params=params,
                     scfg=SuperviseConfig(steps=min(STEPS, 8)),
                     batch_size=4, seq_len=32, device=dev)
    sres = sup.run()
    print(f"supervisor: online over the same run in {time.time()-t0:.1f}s -> "
          f"first flagged step {sres.first_flagged_step}, first bad step "
          f"{sres.first_bad_step} (localized: {sres.localized_module}) — "
          f"the loss curve was still within {gap*100:.2f}% after {STEPS} "
          f"steps")


if __name__ == "__main__":
    main()

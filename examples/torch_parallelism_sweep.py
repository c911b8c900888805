"""Paper §6.2 on the PyTorch port: sweep-test parallelism combinations with
TTrace.

The counterpart of ``examples/parallelism_sweep.py``: every (dp, cp, tp,
sp, zero1) combination of the port's distributed candidate (ranks
emulated in one process) that fits ``--max-devices`` is checked in one
iteration against the single-device reference; any FAIL is a silent bug
in the distribution layer.  All combinations pass on the shipped code;
the bugs appear only when injected with ``--bug``.  The port refuses a
bug that a candidate cannot express (a tp bug without tp), so such a
combination runs without it: the clean run the reference's no-op
injection gives.

    PYTHONPATH=src python examples/torch_parallelism_sweep.py \\
        [--bug <bug_id>] [--max-devices N] [--device cuda|cpu]
"""
import argparse
import dataclasses
import itertools
import time


def sweep_combos(max_devices: int) -> list:
    """The ``ParallelConfig`` of every combination the sweep checks: 2 to
    ``max_devices`` ranks, sp only with tp."""
    from repro_torch.parallel.api import ParallelConfig
    combos = []
    for dp, cp, tp in itertools.product((1, 2), (1, 2), (1, 2)):
        for sp in (False, True):
            for z1 in (False, True):
                pc = ParallelConfig(dp=dp, cp=cp, tp=tp, sp=sp, zero1=z1)
                if pc.n_devices < 2 or pc.n_devices > max_devices:
                    continue
                if sp and tp == 1:
                    continue
                combos.append(pc)
    return combos


def main():
    from repro_torch.bugs.registry import BUGS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bug", default=None, choices=[None, *BUGS])
    ap.add_argument("--max-devices", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    bugs = frozenset([args.bug]) if args.bug else frozenset()

    from repro_torch.launch.supervise import deterministic_mode
    if args.device == "cuda":
        deterministic_mode()
    from repro_torch.configs.base import get_config
    from repro_torch.core.collector import named_params
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.api import (candidate_features,
                                          make_candidate_runner)

    dev = args.device
    cfg = dataclasses.replace(get_config("gpt-paper").reduced(),
                              n_layers=2, vocab=512, tie_embeddings=True)
    model = Model(cfg, seed=0, device=dev)
    params = {k: p.detach() for k, p in named_params(model).items()}
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    batch = make_batch(cfg, 4, 32, device=dev)
    reference = make_model_runner(model, opt, state, device=dev)

    combos = [dataclasses.replace(pc, bugs=frozenset(
        b for b in bugs
        if set(BUGS[b].requires) <= candidate_features(cfg, pc)))
        for pc in sweep_combos(args.max_devices)]
    print(f"sweeping {len(combos)} parallelism combinations "
          f"({'bug: ' + args.bug if args.bug else 'no injected bug'})\n")
    print(f"{'dp':>3} {'cp':>3} {'tp':>3} {'sp':>5} {'zero1':>6}  result")
    n_fail = 0
    for pc in combos:
        t0 = time.time()
        cand = make_candidate_runner(cfg, pc, params, opt, state, device=dev)
        res = ttrace_check(reference, cand, batch, localize=False)
        ok = res.passed
        n_fail += (not ok)
        print(f"{pc.dp:>3} {pc.cp:>3} {pc.tp:>3} {str(pc.sp):>5} "
              f"{str(pc.zero1):>6}  {'PASS' if ok else 'FAIL'} "
              f"({len(res.report.flagged)} flagged, {time.time()-t0:.0f}s)")
    print(f"\n{len(combos) - n_fail}/{len(combos)} combinations equivalent "
          f"to the reference"
          + (" — bug detected where applicable" if n_fail else ""))


if __name__ == "__main__":
    main()

"""Detect and localize a real silent bug with TTrace on the PyTorch port.

The counterpart of ``examples/find_injected_bug.py``: injects a bug from
the registry (default: paper bug 1, the tensor-parallel vocab embedding's
wrong ownership mask) into the port's manual-collectives distributed GPT,
whose ranks are emulated in one process (a ``pp_*`` bug into the staged
or 1F1B pipeline, 2 stages; an MoE bug such as paper bug 6,
``moe_router_not_synced``, into reduced ``mixtral-8x7b``'s expert-parallel
candidate), then runs threshold estimation, differential testing against
the single-device model, and rewrite-mode localization.

    PYTHONPATH=src python examples/torch_find_injected_bug.py [bug_id] \\
        [--device cuda|cpu]
"""
import argparse
import dataclasses

from repro_torch.bugs.registry import BUGS, injectable
from repro_torch.configs.base import get_config
from repro_torch.core.harness import make_model_runner, ttrace_check
from repro_torch.data.synthetic import make_batch
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bug_id", nargs="?", default="tp_wrong_embedding_mask",
                    choices=sorted(injectable() - {"fp8_stale_scale"}))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec = BUGS[args.bug_id]
    print(f"injecting: {args.bug_id} [{spec.btype}] — {spec.description}\n"
          f"  (paper analogue: {spec.paper_analogue})")

    req = set(spec.requires)
    # pipeline bugs need layers for two stages to disagree on; MoE bugs an
    # MoE arch (S 32 is within reduced mixtral's window of 64)
    arch = "mixtral-8x7b" if "moe" in req else "gpt-paper"
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              n_layers=4 if "pp" in req else 2, vocab=512,
                              tie_embeddings=True)
    model = Model(cfg, seed=0, device=args.device)
    opt = AdamW(lr=1e-3)
    batch = make_batch(cfg, 4, 32, seed=0, device=args.device)

    bugs = frozenset([args.bug_id])
    if "1f1b" in req:
        pcfg = ParallelConfig(pp=2, pp_schedule="1f1b", microbatches=2,
                              bugs=bugs)
    elif "pp" in req:
        pcfg = ParallelConfig(pp=2, bugs=bugs)
    else:
        pcfg = ParallelConfig(dp=2, cp=2 if "cp" in req else 1, tp=2,
                              sp="sp" in req, zero1="zero1" in req,
                              bugs=bugs)

    reference = make_model_runner(model, opt, device=args.device)
    candidate = make_candidate_runner(cfg, pcfg, model, opt,
                                      device=args.device)

    result = ttrace_check(reference, candidate, batch, localize=True)
    print()
    print(result.summary())
    print(f"\nexpected module: {spec.expected_module}")
    print(f"TTrace localized: {result.localized_module}")


if __name__ == "__main__":
    main()

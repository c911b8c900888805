"""Supervised-run driver: online TTrace over a multi-step training run; the
port of ``repro/launch/supervise.py``, with the same flags and recipe names.

    PYTHONPATH=src python -m repro_torch.launch.supervise --arch \
        tinyllama-1.1b --reduced --steps 8 --bug zero_skipped_update
    # recipe-generic: pipeline-parallel / FP8 candidates, same workflow
    PYTHONPATH=src python -m repro_torch.launch.supervise --recipe pp \
        --reduced --steps 8 --bug pp_wrong_stage_division
    PYTHONPATH=src python -m repro_torch.launch.supervise \
        --recipe fp8-tile128 --reduced --steps 8 --bug fp8_stale_scale

    # the 1F1B pipeline: per-stage parameter leaves, microbatched schedule,
    # per-rank traces merged before checking (stages emulated on one card)
    PYTHONPATH=src python -m repro_torch.launch.supervise --recipe pp-1f1b \
        --pp 4 --microbatches 4 --reduced --layers 8 --steps 8 \
        --bug pp_stale_boundary
    # expert-parallel MoE (mixtral-8x7b by default), paper bug 6
    PYTHONPATH=src python -m repro_torch.launch.supervise --recipe moe \
        --reduced --steps 8 --bug moe_router_not_synced

Runs the single-device reference and the candidate recipe (the
distributed dense/MoE/ZeRO-1 candidate on emulated ranks, the staged or
1F1B pipeline, or FP8 — with any injected registry bug) in lockstep on one
card, checking every step online through the async pipeline; on a flag
the run is bisected to the first bad step and the bug is localized.
``--device cpu`` runs on the CPU.

On the card the run is deterministic, so that a ``--resume`` of a killed
run, a bisection replay and an uninterrupted run agree bit for bit:
``main`` sets ``CUBLAS_WORKSPACE_CONFIG`` before the first CUDA call, turns
on ``torch.use_deterministic_algorithms`` and turns TF32 off.
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import os
import sys

RECIPES = ("dense", "moe", "zero1", "pp", "pp-1f1b",
           "fp8-global", "fp8-per_tensor", "fp8-tile128")
# the recipes of the reference the port does not run yet, with the ROADMAP
# item of each (none is left)
NOT_PORTED: dict[str, str] = {}

# each non-shard_map recipe's OWN injectable feature set: a bug that doesn't
# intersect it would be a silent no-op under that recipe
_RECIPE_FEATURES = {"pp": {"pp"}, "pp-1f1b": {"pp", "1f1b"},
                    "fp8": {"fp8"}}


def deterministic_mode() -> None:
    """Bit-reproducible CUDA runs: call before the first CUDA use."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _refuse_unported(recipe: str) -> None:
    if recipe in NOT_PORTED:
        raise SystemExit(f"recipe {recipe!r} is not ported yet: "
                         f"{NOT_PORTED[recipe]}")


def build_pcfg(args, requires: set, arch_is_moe: bool = False):
    from repro_torch.parallel.api import ParallelConfig
    bugs = frozenset([args.bug]) if args.bug else frozenset()
    recipe = args.recipe or "dense"
    # a bug whose requirements name a recipe pulls that recipe in — but an
    # EXPLICIT conflicting --recipe is refused, never silently replaced
    for feat, forced, fits in (
            ("1f1b", "pp-1f1b", lambda r: r == "pp-1f1b"),
            ("pp", "pp", lambda r: r.startswith("pp")),
            ("fp8", "fp8-global", lambda r: r.startswith("fp8"))):
        if feat in requires and not fits(recipe):
            if args.recipe is not None:
                raise SystemExit(
                    f"bug {args.bug!r} requires the {forced} recipe but "
                    f"--recipe {args.recipe} was given")
            recipe = forced
    _refuse_unported(recipe)
    if recipe.startswith(("pp", "fp8")):
        # refuse explicit shard_map flags instead of silently dropping them
        ignored = [f for f, on in (("--dp", args.dp is not None),
                                   ("--cp", args.cp is not None),
                                   ("--tp", args.tp is not None),
                                   ("--sp", args.sp),
                                   ("--zero1", args.zero1)) if on]
        if ignored:
            raise SystemExit(f"recipe {recipe!r} cannot combine with "
                             f"shard_map flags — {' '.join(ignored)} "
                             f"cannot apply")
        # ... and only express bugs that require their own feature (the pp
        # candidates consult bugs for the stage division and the 1F1B
        # schedule, fp8 for the cast; a shard_map-side bug would be a
        # silent no-op here)
        own = _RECIPE_FEATURES["fp8" if recipe.startswith("fp8")
                               else recipe]
        if args.bug and not (requires & own):
            raise SystemExit(
                f"bug {args.bug!r} is not implemented by the {recipe!r} "
                f"candidate — it injects into the shard_map path")
    if recipe == "pp":
        if args.pp < 2:
            raise SystemExit("--recipe pp needs --pp >= 2 stages")
        pcfg = ParallelConfig(pp=args.pp, bugs=bugs)
    elif recipe == "pp-1f1b":
        if args.pp < 2:
            raise SystemExit("--recipe pp-1f1b needs --pp >= 2 stages")
        if args.microbatches < 2:
            raise SystemExit("--recipe pp-1f1b needs --microbatches >= 2 "
                             "(one microbatch degenerates to the staged "
                             "schedule)")
        if args.batch % args.microbatches:
            raise SystemExit(f"--batch {args.batch} is not divisible into "
                             f"--microbatches {args.microbatches}")
        pcfg = ParallelConfig(pp=args.pp, pp_schedule="1f1b",
                              microbatches=args.microbatches, bugs=bugs)
    elif recipe.startswith("fp8"):
        pcfg = ParallelConfig(fp8=recipe.split("-", 1)[1], bugs=bugs)
    else:
        cp = args.cp if args.cp is not None else (2 if "cp" in requires
                                                  else 1)
        pcfg = ParallelConfig(
            dp=args.dp if args.dp is not None else 2, cp=cp,
            tp=args.tp if args.tp is not None else 2,
            sp=args.sp or "sp" in requires,
            zero1=args.zero1 or recipe == "zero1" or "zero1" in requires,
            bugs=bugs)
    # a bug the built candidate cannot express would silently "pass":
    # refuse instead of reporting a meaningless clean run ("moe" is an
    # arch-side feature — satisfied by the MODEL, so only exempt it when
    # the arch actually has MoE blocks to inject into)
    features = pcfg.features | ({"moe"} if arch_is_moe else set())
    missing = set(requires) - features
    if missing:
        raise SystemExit(
            f"bug {args.bug!r} requires {sorted(missing)} which recipe "
            f"{recipe!r} (arch {args.arch!r}) cannot express — pick a "
            f"matching --recipe / --arch / flags")
    return recipe, pcfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch config name (default tinyllama-1.1b, or "
                         "mixtral-8x7b for --recipe moe)")
    ap.add_argument("--recipe", default=None, choices=RECIPES,
                    help="candidate recipe: dense/moe/zero1 (distributed on "
                         "emulated ranks), pp (staged pipeline), pp-1f1b "
                         "(1F1B pipeline) or an fp8 scaling recipe (default "
                         "dense; a --bug requiring pp, 1f1b or fp8 pulls "
                         "that recipe in)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the arch's layer count")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bug", default=None,
                    help="registry bug id to inject into the candidate")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel size (shard_map recipes; default 2)")
    ap.add_argument("--cp", type=int, default=None,
                    help="context-parallel size (default 1, or 2 when the "
                         "bug requires cp)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel size (default 2)")
    ap.add_argument("--pp", type=int, default=2,
                    help="pipeline stages for --recipe pp / pp-1f1b")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="1F1B microbatches per step (--recipe pp-1f1b)")
    ap.add_argument("--sp", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--check-every", type=int, default=1,
                    help="online check every C-th step (0 = checking off: "
                         "the bare lockstep loop)")
    ap.add_argument("--async-window", type=int, default=2,
                    help="in-flight online checks (0 = synchronous)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="lockstep mode: synchronous spill, checkpoint and "
                         "re-estimation (bit-identical results; for A/B "
                         "timing and determinism checks)")
    ap.add_argument("--reestimate-every", type=int, default=0,
                    help="re-estimate thresholds on the live batch every R "
                         "steps (0 = step-0 estimate + constant widening)")
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--ring-window", type=int, default=4)
    ap.add_argument("--no-spill", action="store_true")
    ap.add_argument("--work-dir", default=None)
    ap.add_argument("--no-stop-on-flag", action="store_true")
    ap.add_argument("--no-localize", action="store_true")
    ap.add_argument("--no-journal", action="store_true",
                    help="skip the fsync'd supervision journal (no resume)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run from its journal; requires "
                         "--work-dir of the interrupted run")
    ap.add_argument("--fault", default=None,
                    help="loud fault to inject (supervise.faults registry: "
                         "crash, hang_check, nan_step, corrupt_spill, "
                         "truncate_ckpt, dead_spill_writer)")
    ap.add_argument("--fault-step", type=int, default=None,
                    help="step the injected fault fires at")
    ap.add_argument("--watchdog-timeout", type=float, default=60.0,
                    help="seconds before a hung check transfer escalates "
                         "to the sync fallback")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    return run(parse_args(argv))[1]


def run(args):
    """Build and drive the supervisor of ``args``; ``(supervisor,
    result)``."""
    if args.recipe is not None:
        _refuse_unported(args.recipe)

    from repro_torch.supervise.faults import make_injector
    try:
        # refusal path: unknown fault, missing/negative step — never a
        # silently ignored malformed spec
        fault = make_injector(args.fault, args.fault_step)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.resume and not args.work_dir:
        raise SystemExit("--resume needs --work-dir (the journal and "
                         "checkpoints of the interrupted run)")

    if args.device != "cpu":
        deterministic_mode()
    from repro_torch.bugs.registry import BUGS, PENDING
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.supervise import SuperviseConfig, Supervisor

    if args.bug is not None and args.bug not in BUGS:
        raise SystemExit(f"unknown bug {args.bug!r}")
    if args.bug in PENDING:
        raise SystemExit(f"bug {args.bug!r} cannot be injected in the port "
                         f"yet: {PENDING[args.bug]}")
    spec = BUGS[args.bug] if args.bug else None
    if args.arch is None:
        args.arch = ("mixtral-8x7b" if args.recipe == "moe"
                     else "tinyllama-1.1b")
    cfg = get_config(args.arch)
    if args.recipe == "moe" and cfg.arch_type != "moe":
        # an explicit non-MoE --arch is refused, never silently replaced
        raise SystemExit(f"--recipe moe needs an MoE arch "
                         f"(e.g. mixtral-8x7b); got --arch {args.arch} "
                         f"[{cfg.arch_type}]")
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # the candidate recipes implement the GPT/Llama/MoE families
    cfg = dataclasses.replace(cfg, tie_embeddings=True)
    recipe, pcfg = build_pcfg(args, set(spec.requires) if spec else set(),
                              arch_is_moe=cfg.arch_type == "moe")

    model = Model(cfg, seed=args.seed, device=args.device)
    opt = AdamW(lr=args.lr)
    scfg = SuperviseConfig(
        steps=args.steps, check_every=args.check_every,
        async_window=args.async_window, ckpt_every=args.ckpt_every,
        reestimate_every=args.reestimate_every,
        ring_window=args.ring_window, spill=not args.no_spill,
        overlap=not args.no_overlap,
        localize=not args.no_localize,
        stop_on_flag=not args.no_stop_on_flag,
        work_dir=args.work_dir, seed=args.seed,
        journal=not args.no_journal,
        watchdog_timeout_s=args.watchdog_timeout)

    print(f"supervising {cfg.name} ({'reduced' if args.reduced else 'full'}) "
          f"over {args.steps} steps on {args.device}: recipe={recipe} "
          f"dp={pcfg.dp} cp={pcfg.cp} tp={pcfg.tp} sp={pcfg.sp} "
          f"zero1={pcfg.zero1} pp={pcfg.pp} "
          f"pp_schedule={pcfg.pp_schedule} microbatches={pcfg.microbatches} "
          f"fp8={pcfg.fp8} "
          f"async_window={args.async_window} check_every={args.check_every} "
          f"reestimate_every={args.reestimate_every}", flush=True)
    if spec:
        print(f"injected: {spec.bug_id} [{spec.btype}] — {spec.description}")
    if fault is not None:
        print(f"fault armed: {fault.spec.fault_id} at step {fault.step} — "
              f"{fault.spec.description}", flush=True)

    sup = Supervisor(model, cfg, pcfg, opt, scfg=scfg,
                     batch_size=args.batch, seq_len=args.seq,
                     log_fn=lambda s: print(s, flush=True), fault=fault,
                     device=args.device)
    res = sup.resume() if args.resume else sup.run()
    print()
    print(res.summary())
    print(f"  recipe={sup.candidate.name} eps={sup.eps:.2e}, "
          f"checked {len(res.checks)} steps, "
          f"{res.timings.get('steps_per_s', 0):.2f} supervised steps/s "
          f"(pipeline peak in-flight {sup.pipe.max_in_flight}, "
          f"ring: {len(sup.ring.in_memory)} in mem / "
          f"{len(sup.ring.on_disk)} spilled, pinned {sorted(sup.ring.pinned)})")
    if spec and res.flagged:
        loc = res.localized_module or "-"
        # "loss" marks bugs with no module to blame (loss-scaling family);
        # everything else — including "optimizer" — must actually match
        ok = (fnmatch.fnmatchcase(loc, spec.expected_module)
              or spec.expected_module == "loss")
        print(f"  expected module: {spec.expected_module}  ->  "
              f"localized: {loc}  [{'MATCH' if ok else 'MISMATCH'}]")
    return sup, res


if __name__ == "__main__":
    result = main()
    # exit nonzero when the verdict contradicts the injection: a clean run
    # that flags, or an injected bug that goes undetected
    injected = any("--bug" in a for a in sys.argv[1:])
    sys.exit(1 if result.flagged != injected else 0)

"""Pipeline-parallel staged execution + the stage-division silent bug: the
port of ``repro/parallel/pp.py``.

The staged candidate models pipeline parallelism's *semantic* content —
which stage owns which layers, and how stage-local layer indices map back
to the reference numbering (paper Fig 5) — in one process:

* ``stage_division`` computes each stage's [start, end) global layer range,
  distributing any remainder one-per-stage from the front (Megatron-style
  uneven PP) so every layer runs exactly once for ANY (L, pp); with
  ``pp_wrong_stage_division`` injected, boundaries are computed with a
  rounded layers-per-stage (the classic ``ceil(L/pp)`` bug): one layer is
  executed twice at a stage boundary and another never runs — silent, loss
  still decreases, the model is simply wrong (paper bug 10).
* ``stage_layer_table`` precomputes the (executed layer, canonical name
  index) pairs in execution order — the STAGE-LOCAL → global renaming that
  both the one-shot runner and the supervisor's train step apply to their
  tap names.
* ``make_pp_runner`` executes the model stage by stage with canonical tap
  names aligned with the single-device reference; ``make_pp_train_step`` is
  the stateful FULL train step (the supervisor's ``CandidateStep`` contract
  for ``--recipe pp``).

The loss ends with the plain cross-entropy over the full logits, as the
reference's staged loss does (never the model's chunked one).
"""
from __future__ import annotations

import math

from repro_torch.core.tap import ensure_ctx


def stage_division(n_layers: int, pp_size: int,
                   bugs=frozenset()) -> list[tuple[int, int]]:
    if "pp_wrong_stage_division" in bugs:
        # W-CP: ceil-based boundaries overlap by one layer per boundary and
        # drop the tail — stage i executes [i*cpl_bad, ...) with
        # cpl_bad = ceil(L/pp) clipped at L, so a layer repeats and the last
        # layer(s) never run.
        cpl = math.ceil(n_layers / pp_size) if pp_size > 1 else n_layers
        out = []
        for r in range(pp_size):
            start = min(r * cpl - (1 if r else 0), n_layers)
            end = min(start + cpl, n_layers)
            out.append((start, end))
        return out
    # exact partition: base layers per stage, remainder distributed
    # one-per-stage from the front (Megatron uneven pipeline division) —
    # floor alone would silently drop the last L % pp layers
    base, rem = divmod(n_layers, pp_size)
    out, start = [], 0
    for r in range(pp_size):
        end = start + base + (1 if r < rem else 0)
        out.append((start, end))
        start = end
    return out


def stage_layer_table(n_layers: int, pp_size: int,
                      bugs=frozenset()) -> list[tuple[int, int]]:
    """Static ``(executed_layer, canonical_index)`` pairs in execution order.

    The canonical index is reconstructed from (pp_rank, local index) under
    the CORRECT division — exactly the renaming a per-rank trace would apply
    (paper Fig 5; for divisible layer counts it coincides with
    ``core.canonical.canonical_layer_index``) — so when the injected bug
    shifts the executed ranges the names stay put and the trace misaligns
    with the reference.  Buggy overlapping stages can claim an already-used
    canonical index on uneven divisions; those spill to fresh indices >= L
    (absent from the reference, reported as extra candidate tensors)
    instead of colliding in one trace.
    """
    stages = stage_division(n_layers, pp_size, bugs)
    correct = stage_division(n_layers, pp_size)
    table, used, overflow = [], set(), n_layers
    for pp_rank, (start, end) in enumerate(stages):
        for local_idx in range(end - start):
            canon = correct[pp_rank][0] + local_idx
            if canon in used:
                canon, overflow = overflow, overflow + 1
            used.add(canon)
            table.append((start + local_idx, canon))
    return table


def _pp_loss_call(model, pp_size: int, bugs=frozenset()):
    """``loss_call(batch, ctx)`` of the stage-partitioned candidate over
    ``model``'s own parameters, with canonical (global) tap names."""
    from repro_torch.models.layers import _logits, cross_entropy, rmsnorm
    cfg = model.cfg
    table = stage_layer_table(cfg.n_layers, pp_size, bugs)

    def loss_call(batch, ctx):
        ctx = ensure_ctx(ctx)
        h = model.embed(batch, ctx)
        # dense attn_mlp blocks carry no aux loss
        for executed, canon in table:
            with ctx.scope(f"layers.{canon}"):
                h, _ = model.layers[executed](h, ctx)
        h = rmsnorm(model.final_norm, h)
        h = ctx.tap("final_norm_out", h)
        e = (model.embedding.word_embeddings if cfg.tie_embeddings
             else model.lm_head)
        return cross_entropy(_logits(h, e), batch["labels"])

    return loss_call


def make_pp_runner(model, pp_size: int, opt=None, opt_state=None,
                   bugs=frozenset(), device="cuda"):
    """Runner(batch, rewrites) -> Trace for the stage-partitioned candidate
    over ``model`` (whose parameters a run never changes).

    Tap names use canonical (global) layer indices reconstructed from
    (pp_rank, local index) — identical to the reference's names when the
    division is correct."""
    from repro_torch.core.collector import named_params, trace_fn_step
    from repro_torch.core.harness import inputs_on, runner_device
    dev = runner_device(model, device)
    loss_call = _pp_loss_call(model, pp_size, bugs)
    params = named_params(model)

    def run(batch, rewrites=None):
        b, rw = inputs_on(dev, batch, rewrites)
        tr, _, _ = trace_fn_step(loss_call, params, b, opt=opt,
                                 opt_state=opt_state, rewrites=rw)
        return tr

    return run


def make_pp_train_step(model, opt, pp_size: int, bugs=frozenset(),
                       device="cuda"):
    """Stateful PP candidate train step (the supervisor's contract) over
    ``model``'s parameter leaves: ``(step, params0, opt_state0)`` with
    ``step(params, opt_state, batch) -> (Trace, new_params,
    new_opt_state)``; nothing is updated in place."""
    from repro_torch.core.collector import make_trace_step, named_params
    from repro_torch.core.harness import runner_device
    runner_device(model, device)
    params = named_params(model)
    params0 = {k: p.detach().clone() for k, p in params.items()}
    step = make_trace_step(_pp_loss_call(model, pp_size, bugs), opt, params)
    return step, params0, opt.init(params0)

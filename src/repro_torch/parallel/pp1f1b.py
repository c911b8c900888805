"""1F1B pipeline parallelism with per-rank trace merging: the port of
``repro/parallel/pp1f1b.py``.

Unlike ``parallel.pp`` — a *staged* candidate that applies the canonical
stage-local -> global renaming inside one loss — this engine runs the
pipeline the way a PP framework does (paper §5, Fig 5):

* the model is partitioned into per-stage parameter leaves: stage ``s``
  holds only its own layer slice, plus the embedding on stage 0 and the
  final norm / LM head on the last stage.  Tied embeddings are replicated
  on both ends and their gradients explicitly reduced across the two
  stages (Megatron-style tied-embedding all-reduce);
* execution follows the **1F1B microbatch schedule** (``stage_op_stream``
  per stage: warmup forwards, steady one-forward-one-backward, cooldown
  backwards), driven dependency-first (``walk_1f1b``) or in the clock-tick
  order (``schedule_1f1b``), with stage-boundary handoffs through the
  ``BoundaryTransport`` seam and a bounded per-stage activation stash (the
  1F1B memory property: stage ``s`` stashes at most ``pp - s`` inputs);
* each (stage, microbatch) op emits a rank-LOCAL trace — stage-local layer
  names, microbatch-sized leaves — merged into the reference-shaped trace
  by the build-once ``core.merger.MergePlan`` BEFORE any checking,
  identical to ``merge_microbatch_traces`` bit for bit;
* the plan's packed per-stage gradients double as the source of the
  reference-named global gradients for the optimizer step.

The reference places each stage on its own (forced host) device.  Here the
stages are emulated in one process on one device, the card by default: a
boundary "transfer" is a tensor handoff, and every op is issued to one
stream, so the two drives differ only in the global issue order — the
per-stage op order, and with it every trace, is the same.

Forward ops run under ``torch.no_grad()`` and record only the taps, so no
autograd graph outlives its op.  Backward ops recompute their stage's
forward from the stashed boundary input under autograd (stage-granular
activation checkpointing, with zero probes for the activation gradients)
— exactly the surface the two schedule-layer bugs corrupt:

* ``pp_microbatch_order`` — the backward recompute reads the NEXT
  microbatch's stashed input (and, on stage 0, re-embeds its tokens), so
  gradients are accumulated against the wrong microbatch's activations.
  Forward — and therefore the loss curve — is byte-identical to the
  correct schedule;
* ``pp_stale_boundary`` — stage ``i+1`` consumes the previous microbatch's
  boundary activation (a stale recv slot).  Microbatch 0 is correct and
  every consumed tensor is a real activation, so the loss stays plausible.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from repro_torch.core.collector import Trace, _tree_key, named_params
from repro_torch.core.merger import _LAYER_RE, MergePlan
from repro_torch.core.tap import TraceContext
from repro_torch.parallel.pp import stage_division, stage_layer_table


# ---------------------------------------------------------------------------
# Schedule (pure; a copy of the reference's)
# ---------------------------------------------------------------------------

def stage_tables(n_layers: int, pp_size: int,
                 bugs=frozenset()) -> list[list[tuple[int, int]]]:
    """Per-stage ``[(executed_layer, canonical_index), ...]`` — the flat
    ``stage_layer_table`` grouped by owning stage, i.e. the renaming each
    RANK would apply to its local trace (paper Fig 5)."""
    stages = stage_division(n_layers, pp_size, bugs)
    flat = stage_layer_table(n_layers, pp_size, bugs)
    out, i = [], 0
    for start, end in stages:
        out.append(flat[i:i + (end - start)])
        i += end - start
    return out


def stage_op_stream(pp_size: int, stage: int,
                    n_microbatches: int) -> list[tuple[str, int, int]]:
    """Canonical per-stage 1F1B op stream ``[("F"|"B", stage, mb), ...]``:
    ``min(M, pp - 1 - stage)`` warmup forwards, then one-forward-one-backward
    pairs, then cooldown backwards (Megatron's non-interleaved schedule)."""
    M = n_microbatches
    warm = min(M, pp_size - 1 - stage)
    ops = [("F", stage, m) for m in range(warm)]
    for i in range(M - warm):
        ops.append(("F", stage, warm + i))
        ops.append(("B", stage, i))
    ops += [("B", stage, m) for m in range(M - warm, M)]
    return ops


def walk_1f1b(streams, visit, max_per_visit: int | None = None) -> None:
    """Dependency-driven walk of per-stage 1F1B op streams: ``visit(d, s,
    m)`` fires as soon as the op's cross-stage dependency is met (forward
    (s, m) needs forward (s-1, m); backward (s, m) needs backward
    (s+1, m)), per-stage order fixed by the streams.  The engine drives
    through it greedily and ``schedule_1f1b`` replays it with
    ``max_per_visit=1`` (the clock-tick linearization), so the two can
    never drift."""
    S = len(streams)
    ptr = [0] * S
    done_f: set = set()
    done_b: set = set()
    remaining = sum(len(st) for st in streams)
    while remaining:
        progressed = False
        for s in range(S):
            taken = 0
            while ptr[s] < len(streams[s]) and (max_per_visit is None
                                                or taken < max_per_visit):
                d, _, m = streams[s][ptr[s]]
                ready = (d == "F" and (s == 0 or (s - 1, m) in done_f)) or \
                        (d == "B" and (s == S - 1 or (s + 1, m) in done_b))
                if not ready:
                    break
                visit(d, s, m)
                (done_f if d == "F" else done_b).add((s, m))
                ptr[s] += 1
                taken += 1
                remaining -= 1
                progressed = True
        if not progressed:       # impossible for a well-formed 1F1B stream
            raise RuntimeError("1F1B schedule deadlocked")


def schedule_1f1b(pp_size: int,
                  n_microbatches: int) -> list[tuple[str, int, int]]:
    """Global execution order: the clock-tick linearization of
    ``walk_1f1b`` (each stage advances at most one op per tick)."""
    streams = [stage_op_stream(pp_size, s, n_microbatches)
               for s in range(pp_size)]
    order: list[tuple[str, int, int]] = []
    walk_1f1b(streams, lambda d, s, m: order.append((d, s, m)),
              max_per_visit=1)
    return order


# ---------------------------------------------------------------------------
# Stage-boundary transport
# ---------------------------------------------------------------------------

class _Handoff:
    """A boundary value and the CUDA event recorded behind its producer at
    send time; ready once that event completes (CPU values at once, other
    values when their own ``is_ready`` says so)."""
    __slots__ = ("value", "event")

    def __init__(self, value):
        self.value = value
        self.event = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def is_ready(self) -> bool:
        if self.event is not None:
            return self.event.query()
        probe = getattr(self.value, "is_ready", None)
        return probe() if probe is not None else True


class BoundaryTransport:
    """Stage-boundary activation/gradient handoffs for one iteration — the
    one seam a real interconnect (a point-to-point send/recv between stage
    ranks) would replace.

    Buffers model per-link recv slots: ``recv_act`` does not consume (a
    stale consumer may re-read an old slot — the ``pp_stale_boundary``
    surface); ``evict_act`` frees a slot once the schedule proves it dead,
    bounding live boundary buffers at two per stage pair.

    ``deadline_s`` (optional) bounds each recv: the consumer polls the
    event recorded at send time (``supervise.watchdog.wait_ready``), and a
    producer that never finishes turns into a ``BoundaryTimeout`` naming the
    stage link instead of a stall inside the schedule.  ``None`` (default)
    keeps the plain handoff.
    """

    def __init__(self, deadline_s=None):
        self.deadline_s = deadline_s
        self._act: dict = {}        # (producer stage, mb) -> act for stage+1
        self._grad: dict = {}       # (consumer stage, mb) -> grad for stage

    def _send(self, value):
        return value if self.deadline_s is None else _Handoff(value)

    def _await(self, held, what: str):
        if self.deadline_s is None:
            return held
        from repro_torch.supervise.watchdog import wait_ready
        return wait_ready(held, self.deadline_s, what).value

    def send_act(self, stage: int, mb: int, value) -> None:
        """Stage ``stage``'s forward output for ``mb`` -> stage ``stage+1``."""
        self._act[(stage, mb)] = self._send(value)

    def recv_act(self, stage: int, mb: int):
        """The boundary activation stage ``stage`` produced for ``mb``
        (non-consuming read)."""
        return self._await(self._act[(stage, mb)],
                           f"boundary act {stage}->{stage + 1} mb{mb}")

    def evict_act(self, stage: int, mb: int) -> None:
        self._act.pop((stage, mb), None)

    def send_grad(self, stage: int, mb: int, value) -> None:
        """The cotangent for stage ``stage``'s output of ``mb`` (produced by
        stage ``stage+1``'s backward) -> stage ``stage``."""
        self._grad[(stage, mb)] = self._send(value)

    def recv_grad(self, stage: int, mb: int):
        return self._await(self._grad.pop((stage, mb)),
                           f"boundary grad {stage + 1}->{stage} mb{mb}")


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class PP1F1BEngine:
    """1F1B executor for the dense-arch candidate over a port ``Model``
    (whose modules give each stage's forward; its parameters are never
    read or changed).

    ``collect(params, batch)`` runs a full 1F1B training iteration (forward
    + backward + grad accumulation, NO optimizer step) over ``params``
    (``{flat name: tensor}``, reference layout) and returns the merged
    reference-shaped trace, the reference-named gradients and the
    per-rank ``MergeReport``.  ``last_order`` holds the ``(op, stage, mb)``
    sequence the last collect ran and ``max_stash`` each stage's deepest
    activation stash in it.
    """

    def __init__(self, model, pp_size: int, n_microbatches: int,
                 bugs=frozenset(), dispatch: str = "concurrent",
                 boundary_deadline_s: float | None = None, device="cuda"):
        from repro_torch.core.harness import runner_device
        cfg = model.cfg
        if cfg.arch_type != "dense":
            # homogeneous attn_mlp stacks only: stages with aux-producing
            # blocks (MoE) would need the per-stage aux losses communicated
            # to the loss stage, which this engine does not implement
            raise ValueError("the 1F1B engine covers dense arches only "
                             f"(got arch_type={cfg.arch_type!r})")
        if pp_size < 2:
            raise ValueError("the 1F1B pipeline needs pp >= 2 stages")
        if n_microbatches < 1:
            raise ValueError("need at least one microbatch")
        if dispatch not in ("concurrent", "ordered"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.device = runner_device(model, device)
        self.model, self.cfg = model, cfg
        self.bugs = frozenset(bugs)
        self.pp, self.M = pp_size, n_microbatches
        self.tied = cfg.tie_embeddings
        self.dispatch = dispatch
        self.boundary_deadline_s = boundary_deadline_s
        self.stages = stage_division(cfg.n_layers, pp_size, self.bugs)
        self.tables = stage_tables(cfg.n_layers, pp_size, self.bugs)
        self.streams = [stage_op_stream(pp_size, s, n_microbatches)
                        for s in range(pp_size)]
        self.schedule = schedule_1f1b(pp_size, n_microbatches)
        self._plan: MergePlan | None = None
        self._slices = [self._stage_names(s) for s in range(pp_size)]
        self.last_order: list[tuple[str, int, int]] = []
        self.max_stash = [0] * pp_size

    # ---- partitioning ------------------------------------------------------
    def _stage_names(self, s: int) -> dict:
        """Stage ``s``'s ``{stage-local name: global name}``, in
        ``flatten_named`` order (stage-LOCAL layer list; embedding
        replicated on the first and last stage when tied)."""
        start, end = self.stages[s]
        block = [n for n, _ in self.model.layers[0].named_parameters()]
        out = {f"layers.{i}.{n}": f"layers.{start + i}.{n}"
               for i in range(end - start) for n in block}
        if s == 0:
            out["embedding.word_embeddings"] = "embedding.word_embeddings"
        if s == self.pp - 1:
            out["final_norm"] = "final_norm"
            head = "embedding.word_embeddings" if self.tied else "lm_head"
            out[head] = head
        return dict(sorted(out.items(), key=lambda kv: _tree_key(kv[0])))

    def _slice_params(self, params: dict, s: int) -> dict:
        """Stage ``s``'s own copies of its parameter leaves."""
        return {ln: params[gn].detach().clone()
                for ln, gn in self._slices[s].items()}

    # ---- stage computation -------------------------------------------------
    def _apply(self, s: int, p: dict, h, mb: dict, ctx):
        """Stage forward with stage-LOCAL tap names: embeds on stage 0,
        applies the local layer slice, finishes with norm + loss on the
        last stage (loss = per-microbatch mean CE, so the mean over equal
        microbatches equals the reference full-batch loss)."""
        from repro_torch.models.layers import _logits, cross_entropy, rmsnorm
        from repro_torch.models.model import embed_tokens
        if s == 0:
            h = embed_tokens(p["embedding.word_embeddings"], mb["tokens"],
                             self.model.cdtype, ctx)
        # dense attn_mlp blocks carry no aux loss (enforced in __init__)
        for local, (executed, _) in enumerate(self.tables[s]):
            pre = f"layers.{local}."
            leaves = {k[len(pre):]: v for k, v in p.items()
                      if k.startswith(pre)}
            with ctx.scope(f"layers.{local}"):
                h, _ = functional_call(self.model.layers[executed], leaves,
                                       (h, ctx))
        if s < self.pp - 1:
            return h
        h = rmsnorm(p["final_norm"], h)
        h = ctx.tap("final_norm_out", h)
        e = (p["embedding.word_embeddings"] if self.tied else p["lm_head"])
        return cross_entropy(_logits(h, e), mb["labels"])

    def _forward(self, s, p, h, mb, rew):
        """Forward op: no autograd graph, the taps recorded."""
        ctx = TraceContext("rewrite" if rew else "collect", rewrites=rew)
        with torch.no_grad():
            out = self._apply(s, p, h, mb, ctx)
        return out, ctx.fwd

    def _backward(self, s, p, h, mb, g, rew):
        """Backward op: recompute the stage forward from the stashed input
        under autograd (with zero probes on every tap), seed it with the
        downstream cotangent ``g``; returns (input grad or None on stage 0,
        param grads, act grads)."""
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        if s > 0:
            h = h.detach().requires_grad_()
        ctx = TraceContext("rewrite" if rew else "collect", rewrites=rew,
                           probes=True)
        with torch.enable_grad():
            out = self._apply(s, p, h, mb, ctx)
        wrt = list(p.values()) + list(ctx.probes.values())
        if s > 0:
            wrt.append(h)
        grads = torch.autograd.grad(out, wrt, grad_outputs=g,
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(wrt, grads)]
        n = len(p)
        dp = dict(zip(p, grads[:n]))
        dpr = dict(zip(ctx.probes, grads[n:n + len(ctx.probes)]))
        return (grads[-1] if s > 0 else None), dp, dpr

    # ---- batch / rewrite plumbing ------------------------------------------
    def _split(self, tree: dict, bs: int) -> list[dict]:
        return [{k: v[m * bs:(m + 1) * bs] for k, v in tree.items()}
                for m in range(self.M)]

    def _stage_rewrites(self, rewrites, bs: int):
        """Canonical full-batch rewrites -> ``[stage][mb] -> {local: value}``
        (the inverse of the merger's renaming, sliced per microbatch).  A
        layer's rewrite goes to the stage whose table holds its canonical
        index; the others (embedding, final norm) go to every stage and
        apply where that stage taps the name."""
        if not rewrites:
            return None
        out = [dict() for _ in range(self.pp)]
        for cn, v in rewrites.items():
            m = _LAYER_RE.match(cn)
            for s, table in enumerate(self.tables):
                if m is None:
                    out[s][cn] = v
                    continue
                for local, (_, canon) in enumerate(table):
                    if canon == int(m.group(1)):
                        out[s][f"layers.{local}{m.group(2)}"] = v
        return [self._split(r, bs) for r in out]

    # ---- the 1F1B iteration ------------------------------------------------
    def run_schedule(self, params: dict, batch: dict, rewrites=None):
        """Every (stage, microbatch) op of one iteration, in the 1F1B
        schedule.  Returns ``(records, losses)``: the rank-local traces as
        ``[(stage, mb, Trace)]`` in canonical (stage, mb, op) order — the
        merge's input, identical whichever drive ran them — and the
        per-microbatch losses (device tensors)."""
        from repro_torch.core.harness import inputs_on
        M, S = self.M, self.pp
        batch, rewrites = inputs_on(self.device, batch, rewrites)
        B = int(batch["tokens"].shape[0])
        if B % M:
            raise ValueError(f"batch size {B} not divisible into {M} "
                             f"microbatches")
        bs = B // M
        mbs = self._split(batch, bs)
        rew = self._stage_rewrites(rewrites, bs)
        ps = [self._slice_params(params, s) for s in range(S)]
        cot = torch.tensor(1.0 / M, dtype=torch.float32, device=self.device)
        stale = "pp_stale_boundary" in self.bugs
        misorder = "pp_microbatch_order" in self.bugs

        tp = BoundaryTransport(deadline_s=self.boundary_deadline_s)
        stash: list[dict] = [dict() for _ in range(S)]
        losses: list = [None] * M
        records: dict = {}             # (s, m, d) -> rank-local Trace
        self.last_order = []
        self.max_stash = [0] * S

        def run_op(d, s, m):
            self.last_order.append((d, s, m))
            r = rew[s][m] if rew else {}
            if d == "F":
                if s == 0:
                    h_in = None
                else:
                    # boundary recv: the stale-boundary bug re-reads the
                    # previous microbatch's recv slot
                    src = m - 1 if (stale and m > 0) else m
                    h_in = tp.recv_act(s - 1, src)
                out, taps = self._forward(s, ps[s], h_in, mbs[m], r)
                stash[s][m] = h_in
                self.max_stash[s] = max(self.max_stash[s], len(stash[s]))
                if s == S - 1:
                    losses[m] = out
                else:
                    tp.send_act(s, m, out)
                if s > 0 and m > 0:
                    # recv-slot eviction: slot (s-1, k) feeds forward (s, k)
                    # and — under the stale-boundary bug — forward (s, k+1);
                    # once (s, m) ran, (s-1, m-1) is dead, so at most two
                    # slots live per stage pair
                    tp.evict_act(s - 1, m - 1)
                tr = Trace()
                tr.activations = taps
                tr.meta.update(stage=s, microbatch=m, fwd_order=list(taps))
            else:
                # the microbatch-order bug misindexes the activation stash
                # (and, on stage 0, the token microbatch it re-embeds)
                src = m + 1 if (misorder and (m + 1) in stash[s]) else m
                h_in = stash[s][src]
                mb_in = mbs[src if s == 0 else m]
                g = cot if s == S - 1 else tp.recv_grad(s, m)
                dh, dp, dpr = self._backward(s, ps[s], h_in, mb_in, g, r)
                del stash[s][m]
                if s > 0:
                    tp.send_grad(s - 1, m, dh)
                tr = Trace()
                tr.act_grads = dpr
                tr.param_grads = dp
                tr.meta.update(stage=s, microbatch=m)
            records[(s, m, d)] = tr

        if self.dispatch == "ordered":
            for d, s, m in self.schedule:
                run_op(d, s, m)
        else:
            walk_1f1b(self.streams, run_op)

        # canonical record order (driver-independent): the MergePlan
        # signature and the merged trace are identical either way
        return [(s, m, records[(s, m, d)]) for (s, m, d) in
                sorted(records)], losses

    def collect(self, params: dict, batch: dict, rewrites=None):
        """One full 1F1B training iteration.  Returns ``(merged_trace,
        grads, merge_report)``: ``grads`` is ``{reference name: tensor}``
        in ``params``' order; the merged trace's loss stays a device
        tensor."""
        rec_list, losses = self.run_schedule(params, batch, rewrites)
        M, S = self.M, self.pp
        if self._plan is None:
            self._plan = MergePlan.build(rec_list, self.tables, M)
        merged, report = self._plan.execute(rec_list)
        stage_pg = self._plan.stage_param_grads
        if stage_pg is None:           # fell back (foreign record structure)
            stage_pg = {}
            for s, _, tr in rec_list:
                for n, g in tr.param_grads.raw_items():
                    key = (s, n)
                    stage_pg[key] = (stage_pg[key] + g if key in stage_pg
                                     else g)
        loss = losses[0]
        for m in range(1, M):
            loss = loss + losses[m]
        merged.loss = loss / M
        merged.meta["microbatches"] = M
        merged.meta["pp"] = S
        return merged, self._global_grads(params, stage_pg), report

    def _global_grads(self, params: dict, stage_pg: dict) -> dict:
        """Per-stage accumulated grads ``{(stage, local name): leaf}`` ->
        reference-named gradients.  Stage-local layer indices map to the
        EXECUTED global layers (a twice-executed layer's contributions sum,
        as autograd does on the staged candidate); never-executed layers
        get zero grads; tied-embedding contributions from both pipeline
        ends are summed (the explicit tied-embedding reduction)."""
        named: dict = {}
        for (s, n), g in stage_pg.items():
            m = _LAYER_RE.match(n)
            tgt = (f"layers.{self.stages[s][0] + int(m.group(1))}{m.group(2)}"
                   if m else n)
            named[tgt] = named[tgt] + g if tgt in named else g
        return {n: named[n] if n in named else torch.zeros_like(v)
                for n, v in params.items()}


# ---------------------------------------------------------------------------
# Supervisor / harness entry points (the CandidateStep contract)
# ---------------------------------------------------------------------------

def make_pp1f1b_train_step(model, opt, pp_size: int, microbatches: int,
                           bugs=frozenset(), device="cuda"):
    """Stateful 1F1B candidate train step (the supervisor's contract):
    ``(step, params0, opt_state0)`` with ``step(params, opt_state, batch)
    -> (Trace, new_params, new_opt_state)``.  One engine serves every
    supervised step and bisection replay; nothing is updated in place."""
    eng = PP1F1BEngine(model, pp_size, microbatches, bugs, device=device)

    def step(params, opt_state, b):
        tr, grads, _ = eng.collect(params, b)
        new_p, new_st, info = opt.update(params, grads, opt_state)
        tr.main_grads = info.main_grads
        tr.params_post = new_p
        tr.grad_norm = info.grad_norm
        return tr, new_p, new_st

    params0 = {k: p.detach().clone() for k, p in named_params(model).items()}
    return step, params0, opt.init(params0)


def make_pp1f1b_runner(model, pp_size: int, microbatches: int, opt=None,
                       opt_state=None, bugs=frozenset(), device="cuda"):
    """``runner(batch, rewrites) -> Trace`` over the 1F1B engine and
    ``model``'s parameters (which a run never changes) — the rewrite-mode
    localization side of the candidate."""
    eng = PP1F1BEngine(model, pp_size, microbatches, bugs, device=device)
    params = {k: p.detach() for k, p in named_params(model).items()}

    def run(batch, rewrites=None) -> Trace:
        tr, grads, _ = eng.collect(params, batch, rewrites=rewrites)
        tr.loss = float(tr.loss)
        if opt is not None:
            st = opt_state if opt_state is not None else opt.init(params)
            new_p, _, info = opt.update(params, grads, st)
            tr.main_grads = info.main_grads
            tr.params_post = new_p
            tr.grad_norm = float(info.grad_norm)
        return tr

    return run

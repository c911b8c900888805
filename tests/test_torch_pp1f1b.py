"""The port's 1F1B pipeline engine (``repro_torch.parallel.pp1f1b``)
against the reference's (``repro.parallel.pp1f1b.PP1F1BEngine`` on forced
host devices), on the CPU.

At (L 4, pp 2, M 2) and (L 5, pp 3, M 4) of ``tests/test_pp1f1b.py``'s
tiny config:

* the merged names biject with the JAX merged trace and with the port's
  own single-device trace; the accumulated gradients are within 1e-4 of
  the full-batch gradients;
* the reference's ``compare_traces``, under the JAX f32 thresholds, passes
  the port's clean candidate trace;
* ``pp_stale_boundary`` and ``pp_microbatch_order`` get the JAX check's
  verdict and module; under ``pp_microbatch_order`` the port's forward is
  byte-identical to its clean one;
* the per-stage op order is ``stage_op_stream`` under both drives, which
  give bit-identical traces; no stage stashes more than ``pp - s`` inputs;
  the engine's plan-merged trace equals ``merge_microbatch_traces`` of the
  same records bit for bit; a never-ready boundary handoff times out.

Then the Supervisor over the 1F1B candidate against the JAX Supervisor,
and ROADMAP C5: the eps rule of ``CandidateStep.build`` at bf16 compute.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread, to_jax_trace  # noqa: E402
from test_torch_pp import (assert_same_outcome, gpt4,  # noqa: E402
                           supervise_both)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.parallel import api as japi  # noqa: E402
from repro.parallel.pp1f1b import PP1F1BEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.collector import SECTION_FIELDS, trace_train_step  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.core.merger import MergePlan, merge_microbatch_traces  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402
from repro_torch.parallel.pp1f1b import (BoundaryTransport,  # noqa: E402
                                         PP1F1BEngine, stage_op_stream)
from repro_torch.supervise import BoundaryTimeout  # noqa: E402

LR = 1e-3
CASES = [(4, 2, 2), (5, 3, 4)]
IDS = ["L4pp2M2", "L5pp3M4"]
SCHEDULE_BUGS = ("pp_stale_boundary", "pp_microbatch_order")


def setup_module():
    one_thread()


def _tiny(get, L):
    return dataclasses.replace(
        get("gpt-paper").reduced(), n_layers=L, d_model=64, n_heads=2,
        n_kv_heads=2, d_head=32, d_ff=128, vocab=128, tie_embeddings=True)


@functools.lru_cache(maxsize=None)
def setup(L):
    """(jax cfg, jax model, jax params, numpy named params, numpy batch,
    port cfg): tests/test_pp1f1b.py's ``_tiny_cfg`` at B 4 x S 16."""
    jcfg, tcfg = _tiny(jax_get_config, L), _tiny(get_config, L)
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, 4, 16).items()}
    return jcfg, jm, params, named, batch, tcfg


def port_model(L):
    _, _, _, named, _, tcfg = setup(L)
    return params_from_jax(named, Model(tcfg, device="cpu"))


def port_engine(L, pp, M, bugs=frozenset(), **kw):
    return PP1F1BEngine(port_model(L), pp, M, bugs=frozenset(bugs),
                        device="cpu", **kw)


def tensors(named):
    return {k: torch.as_tensor(v) for k, v in named.items()}


def pcfg(pp, M, bugs=()):
    return dict(pp=pp, pp_schedule="1f1b", microbatches=M,
                bugs=frozenset(bugs))


def bit_diffs(t1, t2):
    out = []
    for sec in SECTION_FIELDS:
        s1, s2 = getattr(t1, sec), getattr(t2, sec)
        if list(s1) != list(s2):
            out.append(f"{sec}: names differ")
            continue
        out += [f"{sec}:{n}" for n in s1
                if not torch.equal(s1.raw(n), s2.raw(n))]
    return out


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)


@pytest.mark.parametrize("L,pp,M", CASES, ids=IDS)
def test_engine_names_biject_and_grads_accumulate(forced_devices, L, pp, M):
    jcfg, jm, params, named, batch, tcfg = setup(L)
    jtr, _, jrep = JaxEngine(jm, params, batch, pp, M).collect(params, batch)
    eng = port_engine(L, pp, M)
    tr, grads, rep = eng.collect(tensors(named), batch)
    assert rep.ok and jrep.ok, rep.problems()
    ref, _, _ = trace_train_step(port_model(L), tensors(batch))
    for sec in ("activations", "act_grads", "param_grads"):
        assert set(getattr(tr, sec)) == set(getattr(jtr, sec)) == \
            set(getattr(ref, sec)), sec
    assert list(grads) == list(ref.param_grads)
    for n, g in ref.param_grads.items():
        assert rel_err(g, grads[n].numpy()) < 1e-4, n
        assert rel_err(g, tr.param_grads[n]) < 1e-4, n
    assert abs(float(tr.loss) - ref.loss) <= 1e-5 * abs(ref.loss)
    # the 1F1B memory property, and the per-stage order
    for s in range(pp):
        assert eng.max_stash[s] <= pp - s, eng.max_stash
        assert [op for op in eng.last_order if op[1] == s] == \
            stage_op_stream(pp, s, M)


@pytest.mark.parametrize("L,pp,M", CASES, ids=IDS)
def test_drives_plan_and_reruns_are_bit_identical(L, pp, M):
    _, _, _, named, batch, _ = setup(L)
    p = tensors(named)
    out = {}
    for dispatch in ("concurrent", "ordered"):
        eng = port_engine(L, pp, M, dispatch=dispatch)
        out[dispatch] = eng.collect(p, batch)
        for s in range(pp):
            assert [op for op in eng.last_order if op[1] == s] == \
                stage_op_stream(pp, s, M)
        assert eng._plan.executions == 1
    assert eng.last_order == eng.schedule
    (t1, g1, _), (t2, g2, _) = out["concurrent"], out["ordered"]
    assert not bit_diffs(t1, t2) and torch.equal(t1.loss, t2.loss)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
    # a second run through the same engine and plan is bit-identical
    t3, _, _ = eng.collect(p, batch)
    assert not bit_diffs(t2, t3) and eng._plan.executions == 2
    # the plan merge equals the full merge of the same records
    recs, _ = eng.run_schedule(p, batch)
    full, frep = merge_microbatch_traces(recs, eng.tables, M)
    planned, prep = MergePlan.build(recs, eng.tables, M).execute(recs)
    assert frep.ok and prep.ok
    assert not bit_diffs(full, planned) and not bit_diffs(full, t1)


@functools.lru_cache(maxsize=None)
def jax_reference(L):
    _, jm, params, _, batch, _ = setup(L)
    opt = JaxAdamW(lr=LR)
    st = opt.init(params)
    run = jax_runner(jm, params, opt, st)
    thr, trace = estimate_thresholds(run, batch, MACHINE_EPS["float32"])
    return run, thr, trace, opt, st


@pytest.mark.parametrize("L,pp,M", CASES, ids=IDS)
def test_clean_trace_passes_the_reference_checker(forced_devices, L, pp, M):
    jcfg, jm, params, named, batch, tcfg = setup(L)
    _, thr, jref_trace, _, _ = jax_reference(L)
    port = make_candidate_runner(tcfg, ParallelConfig(**pcfg(pp, M)), named,
                                 AdamW(lr=LR), device="cpu")(batch)
    port = to_jax_trace(port)
    rep = compare_traces(jref_trace, port, thr)
    print(f"L{L} pp{pp} M{M}: {len(rep.records)} tensors, worst "
          f"{max(r.rel_err / r.threshold for r in rep.records):.3g}")
    assert rep.passed and not rep.missing, rep.summary()
    assert len(rep.records) == sum(len(getattr(jref_trace, s))
                                   for s in SECTION_FIELDS)


@pytest.mark.parametrize("bug", SCHEDULE_BUGS)
@pytest.mark.parametrize("L,pp,M", CASES, ids=IDS)
def test_schedule_bug_gives_the_jax_verdict_and_module(forced_devices, L, pp,
                                                       M, bug):
    jcfg, jm, params, named, batch, tcfg = setup(L)
    jref, _, _, jopt, st = jax_reference(L)
    jres = jax_check(jref, japi.make_candidate_runner(
        jcfg, japi.ParallelConfig(**pcfg(pp, M, [bug])), params, jopt, st),
        batch)
    tres = ttrace_check(
        make_model_runner(port_model(L), AdamW(lr=LR), device="cpu"),
        make_candidate_runner(tcfg, ParallelConfig(**pcfg(pp, M, [bug])),
                              named, AdamW(lr=LR), device="cpu"), batch)
    print(f"{bug} L{L} pp{pp} M{M}: jax {jres.passed} "
          f"{jres.localized_module} ({jres.report.localized}), port "
          f"{tres.passed} {tres.localized_module} ({tres.report.localized})")
    assert not jres.passed and not tres.passed
    assert np.isfinite(tres.candidate.loss)
    assert tres.report.localized == jres.report.localized
    assert tres.localized_module == jres.localized_module


@pytest.mark.parametrize("L,pp,M", CASES, ids=IDS)
def test_microbatch_order_bug_leaves_forward_untouched(L, pp, M):
    _, _, _, named, batch, _ = setup(L)
    p = tensors(named)
    clean, gc, _ = port_engine(L, pp, M).collect(p, batch)
    bad, gb, rep = port_engine(L, pp, M, ["pp_microbatch_order"]).collect(
        p, batch)
    assert rep.ok and torch.equal(clean.loss, bad.loss)
    assert list(clean.activations) == list(bad.activations)
    for n in clean.activations:
        assert torch.equal(clean.activations.raw(n), bad.activations.raw(n))
    assert any(not torch.allclose(gc[n], gb[n], rtol=1e-3) for n in gc), \
        "backward bug never expressed"


def test_stale_boundary_keeps_slot_bound_and_a_deadline_passes():
    _, _, _, named, batch, _ = setup(5)
    eng = port_engine(5, 3, 4, ["pp_stale_boundary"], boundary_deadline_s=5.0)
    tr, _, rep = eng.collect(tensors(named), batch)
    assert rep.ok and np.isfinite(float(tr.loss))
    clean, _, _ = port_engine(5, 3, 4).collect(tensors(named), batch)
    # microbatch 0 of every stage is correct, the later ones are not
    h = "layers.2.self_attention/input"
    assert torch.equal(tr.activations.raw(h)[:1], clean.activations.raw(h)[:1])
    assert not torch.equal(tr.activations.raw(h), clean.activations.raw(h))


def test_never_ready_handoff_raises_boundary_timeout():
    class NeverReady:
        def is_ready(self):
            return False

    tp = BoundaryTransport(deadline_s=0.05)
    tp.send_act(0, 0, NeverReady())
    with pytest.raises(BoundaryTimeout, match="boundary act 0->1 mb0"):
        tp.recv_act(0, 0)
    tp.send_grad(1, 2, NeverReady())
    with pytest.raises(BoundaryTimeout, match="boundary grad 2->1 mb2"):
        tp.recv_grad(1, 2)
    plain = BoundaryTransport()           # no deadline: the plain handoff
    x = torch.ones(2)
    plain.send_act(0, 0, x)
    assert plain.recv_act(0, 0) is x


def test_engine_refusals():
    m = port_model(4)
    for kw, match in ((dict(pp_size=1, n_microbatches=2), "pp >= 2"),
                      (dict(pp_size=2, n_microbatches=0), "microbatch"),
                      (dict(pp_size=2, n_microbatches=2, dispatch="x"),
                       "dispatch")):
        with pytest.raises(ValueError, match=match):
            PP1F1BEngine(m, device="cpu", **kw)
    eng = PP1F1BEngine(m, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        eng.collect(tensors(setup(4)[3]), setup(4)[4])


# ---------------------------------------------------------------------------
# the Supervisor over the 1F1B candidate, and the eps rule (ROADMAP C5)
# ---------------------------------------------------------------------------

def test_supervisor_pp1f1b_matches_the_jax_supervisor(forced_devices,
                                                      tmp_path):
    out = supervise_both(tmp_path, japi.ParallelConfig(**pcfg(2, 2)),
                         ParallelConfig(**pcfg(2, 2)), B=4)
    assert_same_outcome(*out)
    _, _, tsup, tres = out
    assert tres.passed, tres.summary()
    assert tsup.candidate.name == "pp1f1b2x2"
    assert tsup.pipe.kind_scale == 2.0


def worst_by_step(res) -> dict:
    return {k: round(max(r.rel_err / r.threshold for r in rep.records), 4)
            for k, rep in sorted(res.checks.items())}


# two steps show the verdicts, the flagged and the first bad step at step 0;
# each Supervisor pair's time is the reference's compiles, not its steps
C5_STEPS = 2


def _bf16():
    jcfg, _, params, named, _, tcfg = gpt4(tied=True)
    return dict(jcfg=dataclasses.replace(jcfg, compute_dtype="bfloat16"),
                tcfg=dataclasses.replace(tcfg, compute_dtype="bfloat16"),
                params=params, named=named)


@pytest.mark.parametrize("kind", ["1f1b_clean", "staged_bug"])
def test_bf16_compute_same_explicit_eps_agrees(forced_devices, tmp_path,
                                               kind):
    """ROADMAP C5: reduced gpt-paper at bf16 compute, both Supervisors given
    the same explicit eps (bf16's, the port's own default there): the same
    verdicts, flagged step, first bad step and module."""
    eps = MACHINE_EPS["bfloat16"]
    if kind == "1f1b_clean":
        kw, bugs = pcfg(2, 2), ()
    else:
        kw, bugs = dict(pp=2), ["pp_wrong_stage_division"]
    kw = dict(kw, bugs=frozenset(bugs))
    out = supervise_both(tmp_path, japi.ParallelConfig(**kw),
                         ParallelConfig(**kw), steps=C5_STEPS, B=4, eps=eps,
                         **_bf16())
    assert_same_outcome(*out)
    jsup, jres, tsup, tres = out
    print(f"{kind} at eps {eps:.3g}: worst rel_err/threshold by step, jax "
          f"{worst_by_step(jres)}, port {worst_by_step(tres)}")
    assert tsup.eps == jsup.eps == eps
    assert tres.flagged == bool(bugs), tres.summary()
    if bugs:
        assert tres.first_bad_step == 0
    # the port's default eps at bf16 compute is the eps given here
    from repro_torch.supervise import CandidateStep
    cand = CandidateStep.build(_bf16()["tcfg"], ParallelConfig(**kw),
                               _bf16()["named"], AdamW(lr=LR), device="cpu")
    assert cand.eps == eps


def test_bf16_compute_reference_default_eps_flags_a_clean_run(forced_devices,
                                                              tmp_path):
    """ROADMAP C5, the reference's own default at bf16 compute: f32 eps.
    The clean 1F1B candidate is flagged at step 0 by the JAX Supervisor,
    and by the port's given the same eps explicitly — the reason the port
    widens its default to the compute dtype's eps."""
    kw = pcfg(2, 2)
    jsup, jres, tsup, tres = supervise_both(
        tmp_path, japi.ParallelConfig(**kw), ParallelConfig(**kw),
        steps=C5_STEPS, B=4, eps=MACHINE_EPS["float32"], jax_eps=None,
        **_bf16())
    print(f"reference default eps {jsup.eps:.3g}: flagged at "
          f"{jres.first_flagged_step}, worst rel_err/threshold by step "
          f"{worst_by_step(jres)}; port at the same eps: flagged at "
          f"{tres.first_flagged_step}, module {tres.localized_module} "
          f"(jax {jres.localized_module})")
    assert jsup.eps == tsup.eps == MACHINE_EPS["float32"]
    assert jres.flagged and tres.flagged
    assert jres.first_flagged_step == tres.first_flagged_step == 0
    assert jres.first_bad_step == tres.first_bad_step == 0

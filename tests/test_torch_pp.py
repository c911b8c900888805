"""The port's pipeline half (``repro_torch.parallel.pp``, the PP mapping of
``core.canonical``, the per-rank half of ``core.merger``) against the
reference's, on the CPU.

* Pure parts: ``stage_division``, ``stage_layer_table``, ``stage_tables``,
  ``stage_op_stream``, ``schedule_1f1b``, the canonical PP mapping and
  ``canonical_stage_name`` equal the JAX package's exactly.
* Merging: random per-rank record sets (numpy, from a seed) go through both
  packages' ``merge_microbatch_traces`` and ``MergePlan``; names,
  ``fwd_order`` and ``MergeReport`` fields are identical, concatenations
  equal bit for bit and gradient sums within 1e-6 relative; the port's
  plan equals its own full merge bit for bit and falls back on a foreign
  structure.
* The staged candidate of reduced ``gpt-paper`` (4 layers): the
  reference's ``compare_traces``, under the JAX f32 thresholds, passes the
  port's trace at pp 2 and pp 3; ``pp_wrong_stage_division`` gets the JAX
  check's verdict and module.
* The Supervisor over the staged candidate, clean and under
  ``pp_wrong_stage_division``, against the JAX Supervisor; the CLI's pp
  refusals against the reference's ``build_pcfg``.
"""
import argparse
import dataclasses
import functools
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread, to_jax_trace  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import canonical as JC  # noqa: E402
from repro.core import merger as JM  # noqa: E402
from repro.core.checker import compare_traces  # noqa: E402
from repro.core.collector import Trace as JTrace, flatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.parallel import pp as jpp  # noqa: E402
from repro.parallel import pp1f1b as jpp1f1b  # noqa: E402
from repro.parallel.api import ParallelConfig as JPC  # noqa: E402
from repro.parallel.pp import make_pp_runner as jax_pp_runner  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import canonical as TC  # noqa: E402
from repro_torch.core import merger as TM  # noqa: E402
from repro_torch.core.collector import Trace  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel import pp as tpp  # noqa: E402
from repro_torch.parallel import pp1f1b as tpp1f1b  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402

LR = 1e-3
BUG = frozenset(["pp_wrong_stage_division"])


def setup_module():
    one_thread()


# ---------------------------------------------------------------------------
# pure parts: exact equality with the JAX package's functions
# ---------------------------------------------------------------------------

def test_stage_division_and_tables_equal_the_reference():
    for L in range(1, 49):
        for pp in range(1, 13):
            for bugs in (frozenset(), BUG):
                assert tpp.stage_division(L, pp, bugs) == \
                    jpp.stage_division(L, pp, bugs), (L, pp, bugs)
                assert tpp.stage_layer_table(L, pp, bugs) == \
                    jpp.stage_layer_table(L, pp, bugs), (L, pp, bugs)
                assert tpp1f1b.stage_tables(L, pp, bugs) == \
                    jpp1f1b.stage_tables(L, pp, bugs), (L, pp, bugs)
    # the buggy stage 1 at L 12, pp 4 runs layer 2 under layers.3
    assert tpp.stage_layer_table(12, 4, BUG)[3] == (2, 3)


def test_schedule_equals_the_reference():
    for pp in range(2, 7):
        for M in range(1, 9):
            assert tpp1f1b.schedule_1f1b(pp, M) == jpp1f1b.schedule_1f1b(pp, M)
            for s in range(pp):
                assert tpp1f1b.stage_op_stream(pp, s, M) == \
                    jpp1f1b.stage_op_stream(pp, s, M)
            streams = [tpp1f1b.stage_op_stream(pp, s, M) for s in range(pp)]
            tw, jw = [], []
            tpp1f1b.walk_1f1b(streams, lambda *op: tw.append(op))
            jpp1f1b.walk_1f1b(streams, lambda *op: jw.append(op))
            assert tw == jw


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, KeyError) as e:
        return (type(e).__name__, str(e))


def test_canonical_pp_mapping_equals_the_reference():
    for L in (1, 4, 6, 8, 12, 24):
        for pp in (1, 2, 3, 4):
            for vpp in (1, 2, 3):
                assert _outcome(TC.chunk_layers, L, pp, vpp) == \
                    _outcome(JC.chunk_layers, L, pp, vpp)
                for r in range(-1, pp + 1):
                    for v in range(vpp):
                        for i in range(-1, L // max(pp * vpp, 1) + 1):
                            assert _outcome(TC.canonical_layer_index, i, r,
                                            pp, v, vpp, L) == _outcome(
                                JC.canonical_layer_index, i, r, pp, v, vpp, L)
                for g in range(L):
                    assert _outcome(TC.local_layer_index, g, pp, vpp, L) == \
                        _outcome(JC.local_layer_index, g, pp, vpp, L)
                for mod in ("layers.0.mlp", "layers.1.self_attention.x",
                            "embedding", "model.layers.2"):
                    for r in range(pp):
                        assert _outcome(TC.canonicalize_module, mod, r, pp,
                                        0, vpp, L) == _outcome(
                            JC.canonicalize_module, mod, r, pp, 0, vpp, L)


def test_canonical_stage_name_equals_the_reference():
    tables = [[(2, 2), (3, 3)], [(1, 3), (2, 12)], []]
    names = ["layers.1.mlp/input", "layers.0.self_attention.linear_qkv.w",
             "embedding/output", "final_norm_out", "layers.0",
             "layers.5.mlp/input", "layers.10.mlp/output"]
    for t in tables:
        for n in names:
            assert _outcome(TM.canonical_stage_name, n, t) == \
                _outcome(JM.canonical_stage_name, n, t)


# ---------------------------------------------------------------------------
# merging: the same record sets through both packages
# ---------------------------------------------------------------------------

def _random_records(rng, L, pp, M):
    """tests/test_overlap_determinism.py's generator: per (stage, mb) one
    forward record (acts) and one backward record (act grads + param
    grads), values random."""
    tables = jpp1f1b.stage_tables(L, pp)
    recs = []
    for s in range(pp):
        n_local = len(tables[s])
        for m in range(M):
            acts = {f"layers.{i}.mlp/output":
                    rng.standard_normal((2, 3)).astype(np.float32)
                    for i in range(n_local)}
            if s == 0:
                acts["embedding/output"] = rng.standard_normal(
                    (2, 3)).astype(np.float32)
            pgs = {f"layers.{i}.mlp.down.w":
                   rng.standard_normal((3, 3)).astype(np.float32)
                   for i in range(n_local)}
            if s in (0, pp - 1):
                pgs["embedding.word_embeddings"] = rng.standard_normal(
                    (4, 3)).astype(np.float32)
            recs.append((s, m, dict(act=acts)))
            recs.append((s, m, dict(ag=dict(acts), pg=pgs)))
    return recs, tables


def _as(records, cls, conv):
    out = []
    for s, m, d in records:
        tr = cls()
        if "act" in d:
            tr.activations = {k: conv(v) for k, v in d["act"].items()}
        if "ag" in d:
            tr.act_grads = {k: conv(v) for k, v in d["ag"].items()}
        if "pg" in d:
            tr.param_grads = {k: conv(v) for k, v in d["pg"].items()}
        out.append((s, m, tr))
    return out


def _both(records):
    return (_as(records, JTrace, lambda v: v),
            _as(records, Trace, torch.from_numpy))


KINDS = ("activation", "act_grad", "param_grad")


def _report_fields(rep):
    return (rep.ok, rep.overlap, rep.omission, list(rep.rank_problems),
            list(rep.conflicts))


def _assert_parity(jm, jr, tm, tr):
    assert _report_fields(jr) == _report_fields(tr)
    assert jm.meta["fwd_order"] == tm.meta["fwd_order"]
    for kind in KINDS:
        js, ts = jm.section(kind), tm.section(kind)
        assert list(js) == list(ts), kind
        for n in js:
            a, b = np.asarray(js.raw(n)), ts.raw(n).numpy()
            if kind == "param_grad":
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{kind}/{n}")


def _assert_bit_equal(m1, m2):
    for kind in KINDS:
        s1, s2 = m1.section(kind), m2.section(kind)
        assert list(s1) == list(s2), kind
        for n in s1:
            assert torch.equal(s1.raw(n), s2.raw(n)), (kind, n)
    assert m1.meta["fwd_order"] == m2.meta["fwd_order"]


@pytest.mark.parametrize("L,pp,M", [(4, 2, 2), (5, 3, 4), (7, 4, 3),
                                    (2, 2, 1)])
def test_merge_and_plan_match_the_reference(L, pp, M):
    rng = np.random.default_rng(1000 * L + 10 * pp + M)
    recs, tables = _random_records(rng, L, pp, M)
    jrecs, trecs = _both(recs)
    jm, jr = JM.merge_microbatch_traces(jrecs, tables, M)
    tm, tr = TM.merge_microbatch_traces(trecs, tables, M)
    assert tr.ok and tm.meta["merge_report"] is tr
    _assert_parity(jm, jr, tm, tr)
    jplan = JM.MergePlan.build(jrecs, tables, M)
    tplan = TM.MergePlan.build(trecs, tables, M)
    jp, jpr = jplan.execute(jrecs)
    tp, tpr = tplan.execute(trecs)
    assert tplan.executions == 1 and tplan.fallbacks == 0
    _assert_parity(jp, jpr, tp, tpr)
    _assert_bit_equal(tm, tp)            # the plan IS the full merge
    assert set(tplan.stage_param_grads) == set(jplan.stage_param_grads)
    # a second same-structured record set takes the planned path again
    recs2, _ = _random_records(np.random.default_rng(7), L, pp, M)
    t2 = _both(recs2)[1]
    _assert_bit_equal(TM.merge_microbatch_traces(t2, tables, M)[0],
                      tplan.execute(t2)[0])
    assert tplan.executions == 2 and tplan.fallbacks == 0


def test_plan_falls_back_on_a_foreign_structure():
    rng = np.random.default_rng(3)
    recs, tables = _random_records(rng, 4, 2, 2)
    jrecs, trecs = _both(recs)
    tplan = TM.MergePlan.build(trecs, tables, 2)
    jplan = JM.MergePlan.build(jrecs, tables, 2)
    # foreign: one microbatch's forward record dropped, one contributed twice
    foreign = recs[:2] + recs[3:] + [recs[0]]
    jf, tf = _both(foreign)
    tm, tr = tplan.execute(tf)
    jm, jr = jplan.execute(jf)
    assert tplan.fallbacks == 1 and tplan.stage_param_grads is None
    assert not tr.ok and tr.overlap >= 1 and tr.omission >= 1
    _assert_parity(jm, jr, tm, tr)
    _assert_bit_equal(tm, TM.merge_microbatch_traces(tf, tables, 2)[0])


def test_coverage_verdicts_match_the_reference():
    x = np.ones((2, 2), np.float32)
    tables = jpp1f1b.stage_tables(4, 2)
    cases = [
        ([(0, 0, dict(act={"layers.0.mlp/output": x}))], 2),     # omission
        ([(0, 0, dict(act={"layers.0.mlp/output": x})),
          (0, 0, dict(act={"layers.0.mlp/output": x}))], 1),     # overlap
        ([(7, 0, dict(act={"a": x}))], 1),                        # off grid
        ([(0, 0, dict(pg={"embedding.word_embeddings": x})),
          (1, 0, dict(pg={"embedding.word_embeddings": x}))], 1),  # tied sum
        # collision after renaming: both stages name canonical layers.2
        ([(0, 0, dict(act={"layers.1.mlp/output": x},
                      pg={"layers.1.mlp.w": x})),
          (1, 0, dict(act={"layers.0.mlp/output": x},
                      pg={"layers.0.mlp.w": x}))], 1),
    ]
    collide = [[(0, 0), (1, 2)], [(2, 2), (3, 3)]]
    for i, (recs, M) in enumerate(cases):
        tab = collide if i == 4 else tables
        jrecs, trecs = _both(recs)
        jm, jr = JM.merge_microbatch_traces(jrecs, tab, M)
        tm, tr = TM.merge_microbatch_traces(trecs, tab, M)
        _assert_parity(jm, jr, tm, tr)
        jp, jpr = JM.MergePlan.build(jrecs, tab, M).execute(jrecs)
        tp, tpr = TM.MergePlan.build(trecs, tab, M).execute(trecs)
        _assert_parity(jp, jpr, tp, tpr)
        assert tr.ok == (i == 3), (i, tr.problems())


def test_merge_problems_fail_the_port_check():
    """A coverage violation fails the port's compare even when every value
    agrees."""
    from repro_torch.core.checker import compare_traces as port_compare
    from repro_torch.core.thresholds import Thresholds
    x = torch.ones((2, 2))
    ref = Trace()
    ref.activations = {"layers.0.mlp/output": torch.cat([x, x])}
    recs = []
    for m in (0, 1, 1):
        tr = Trace()
        tr.activations = {"layers.0.mlp/output": x}
        recs.append((0, m, tr))
    merged, rep = TM.merge_microbatch_traces(
        recs, tpp1f1b.stage_tables(4, 2), 2)
    assert not rep.ok
    report = port_compare(ref, merged, Thresholds(eps=2.0 ** -24))
    assert not report.passed and report.merge_problems


# ---------------------------------------------------------------------------
# the staged candidate against the JAX one (tests/test_pp_fp8.py's gpt4)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def gpt4(tied=False):
    """(jax cfg, jax model, jax params, numpy named params, numpy batch,
    port cfg): reduced gpt-paper at 4 layers, vocab 256, B 2 x S 32."""
    jcfg = dataclasses.replace(jax_get_config("gpt-paper").reduced(),
                               n_layers=4, vocab=256, tie_embeddings=tied)
    tcfg = dataclasses.replace(get_config("gpt-paper").reduced(),
                               n_layers=4, vocab=256, tie_embeddings=tied)
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v)
             for k, v in jax_make_batch(jcfg, 2, 32).items()}
    return jcfg, jm, params, named, batch, tcfg


@functools.lru_cache(maxsize=None)
def jax_reference():
    jcfg, jm, params, _, batch, _ = gpt4()
    opt = JaxAdamW(lr=LR)
    st = opt.init(params)
    run = jax_runner(jm, params, opt, st)
    thr, trace = estimate_thresholds(run, batch, MACHINE_EPS["float32"])
    return run, thr, trace, opt, st


def port_model(tied=False):
    _, _, _, named, _, tcfg = gpt4(tied)
    return params_from_jax(named, Model(tcfg, device="cpu"))


def worst(report):
    return max(r.rel_err / r.threshold for r in report.records)


@pytest.mark.parametrize("pp", [2, 3])
def test_staged_candidate_passes_the_reference_checker(pp):
    jcfg, jm, params, named, batch, tcfg = gpt4()
    _, thr, jref_trace, jopt, st = jax_reference()
    jcand = jax_pp_runner(jm, params, pp, opt=jopt, opt_state=st)(batch)
    port = make_candidate_runner(tcfg, ParallelConfig(pp=pp), named,
                                 AdamW(lr=LR), device="cpu")(batch)
    port = to_jax_trace(port)
    for against, ref_trace in (("jax candidate", jcand),
                               ("jax reference", jref_trace)):
        rep = compare_traces(ref_trace, port, thr)
        print(f"pp{pp} vs {against}: {len(rep.records)} tensors, worst "
              f"rel_err/threshold {worst(rep):.3g}")
        assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jcand.meta["fwd_order"]


def test_wrong_stage_division_gives_the_jax_verdict_and_module():
    jcfg, jm, params, named, batch, tcfg = gpt4()
    jres = jax_check(jax_runner(jm, params),
                     jax_pp_runner(jm, params, 2, bugs=BUG), batch)
    tres = ttrace_check(
        make_model_runner(port_model(), device="cpu"),
        make_candidate_runner(tcfg, ParallelConfig(pp=2, bugs=BUG), named,
                              device="cpu"), batch)
    print(f"jax {jres.passed} {jres.localized_module} "
          f"{jres.report.localized}, port {tres.passed} "
          f"{tres.localized_module} {tres.report.localized}")
    assert not jres.passed and not tres.passed
    assert np.isfinite(tres.candidate.loss)
    assert tres.report.localized == jres.report.localized
    assert tres.localized_module == jres.localized_module
    assert tres.report.localized.startswith("layers.2")


@pytest.mark.parametrize("kw", [dict(pp=2), dict(pp=2, pp_schedule="1f1b",
                                                microbatches=2)], ids=str)
def test_pp_train_steps_update_nothing_in_place(kw):
    """Both pipeline steps (the supervisor's contract) leave the state they
    are given as it was, across two steps."""
    _, _, _, named, batch, tcfg = gpt4()
    from repro_torch.parallel.api import make_candidate_train_step
    step, p0, s0 = make_candidate_train_step(
        tcfg, ParallelConfig(**kw), named, AdamW(lr=LR), device="cpu")
    before = {k: v.clone() for k, v in p0.items()}
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    tr, p1, s1 = step(p0, s0, b)
    p1_before = {k: v.clone() for k, v in p1.items()}
    step(p1, s1, b)
    for k in p0:
        assert torch.equal(p0[k], before[k]), k
        assert torch.equal(p1[k], p1_before[k]), k
        assert p1[k] is not p0[k]
    assert set(tr.params_post) == set(p0)


# ---------------------------------------------------------------------------
# the Supervisor over the staged candidate (tests/test_pp_fp8.py's case)
# ---------------------------------------------------------------------------

def _jax_batch_fn(jcfg, B, S):
    @functools.lru_cache(maxsize=None)
    def batch(step):
        return {k: np.asarray(v) for k, v in jax_make_batch(
            jcfg, B, S, seed=0, step=step).items()}
    return batch


_SAME = object()


def supervise_both(tmp_path, jpcfg, tpcfg, steps=4, B=2, S=16, jcfg=None,
                   tcfg=None, named=None, params=None, eps=None,
                   jax_eps=_SAME, **scfg):
    """The JAX and the port Supervisor on the same parameters and batches;
    ``eps`` is the port's ``SuperviseConfig.eps`` and, unless ``jax_eps``
    says otherwise, the JAX side's.  ``(jax sup, jax result, port sup, port
    result)``."""
    from repro.supervise import SuperviseConfig as JSC, Supervisor as JSup
    from repro_torch.supervise import SuperviseConfig, Supervisor
    if jcfg is None:
        jcfg, _, params, named, _, tcfg = gpt4(tied=True)
    batch_fn = _jax_batch_fn(jcfg, B, S)
    jscfg = dict(scfg, eps=eps if jax_eps is _SAME else jax_eps)
    jsup = JSup(JaxModel(jcfg), jcfg, jpcfg, JaxAdamW(lr=LR), params=params,
                scfg=JSC(steps=steps, work_dir=str(tmp_path / "jax"),
                         **jscfg), batch_fn=batch_fn)
    jres = jsup.run()
    tsup = Supervisor(Model(tcfg, device="cpu"), tcfg, tpcfg, AdamW(lr=LR),
                      params=named,
                      scfg=SuperviseConfig(steps=steps, eps=eps,
                                           work_dir=str(tmp_path / "port"),
                                           **scfg),
                      batch_fn=batch_fn, device="cpu")
    tres = tsup.run()
    shutil.rmtree(tmp_path, ignore_errors=True)
    return jsup, jres, tsup, tres


def assert_same_outcome(jsup, jres, tsup, tres):
    print(f"jax: flagged {jres.flagged} first {jres.first_flagged_step} bad "
          f"{jres.first_bad_step} module {jres.localized_module}; port: "
          f"flagged {tres.flagged} first {tres.first_flagged_step} bad "
          f"{tres.first_bad_step} module {tres.localized_module}")
    assert sorted(tres.checks) == sorted(jres.checks)
    assert ({k: r.passed for k, r in tres.checks.items()}
            == {k: r.passed for k, r in jres.checks.items()})
    assert tres.flagged == jres.flagged
    assert tres.first_flagged_step == jres.first_flagged_step
    assert tres.first_bad_step == jres.first_bad_step
    assert tres.localized_module == jres.localized_module
    assert tsup.candidate.name == jsup.candidate.name
    assert tsup.candidate.kind_scale == jsup.candidate.kind_scale
    assert tsup.pipe.kind_scale == jsup.pipe.kind_scale


@pytest.mark.parametrize("bugs", [frozenset(), BUG], ids=["clean", "bug"])
def test_supervisor_pp_matches_the_jax_supervisor(tmp_path, bugs):
    out = supervise_both(tmp_path, JPC(pp=2, bugs=bugs),
                         ParallelConfig(pp=2, bugs=bugs))
    assert_same_outcome(*out)
    _, _, tsup, tres = out
    assert tsup.candidate.name == "pp2"
    if bugs:
        assert tres.flagged and tres.first_bad_step == 0
        assert tres.localized_module.startswith("layers.")
    else:
        assert tres.passed, tres.summary()


# ---------------------------------------------------------------------------
# the CLI's pp refusals, against the reference's build_pcfg
# ---------------------------------------------------------------------------

def _cli_args(**over):
    ns = argparse.Namespace(
        arch=None, recipe=None, bug=None, dp=None, cp=None, tp=None,
        sp=False, zero1=False, pp=2, microbatches=4, batch=4)
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


CLI_CASES = [
    dict(recipe="pp", bug="tp_wrong_embedding_mask"),
    dict(recipe="pp-1f1b", bug="zero_skipped_update"),
    dict(recipe="pp", bug="pp_microbatch_order"),
    dict(recipe="pp", bug="pp_stale_boundary"),
    dict(recipe="dense", bug="pp_stale_boundary"),
    dict(recipe="fp8-tile128", bug="pp_wrong_stage_division"),
    dict(recipe="pp-1f1b", tp=2),
    dict(recipe="pp", zero1=True),
    dict(recipe="pp", pp=1),
    dict(recipe="pp-1f1b", pp=1),
    dict(recipe="pp-1f1b", microbatches=1),
    dict(recipe="pp-1f1b", microbatches=3, batch=4),
    # accepted: the recipe and the bugs that pull it in
    dict(recipe="pp"),
    dict(recipe="pp-1f1b", pp=4, microbatches=4, batch=8),
    dict(bug="pp_stale_boundary"),
    dict(bug="pp_wrong_stage_division"),
    dict(recipe="pp-1f1b", bug="pp_wrong_stage_division"),
]


@pytest.mark.parametrize("over", CLI_CASES, ids=str)
def test_cli_pp_build_pcfg_matches_the_reference(over):
    from repro.bugs.registry import BUGS
    from repro.launch.supervise import build_pcfg as jax_build
    from repro_torch.launch.supervise import build_pcfg as port_build
    requires = set(BUGS[over["bug"]].requires) if over.get("bug") else set()

    def outcome(build):
        try:
            recipe, pcfg = build(_cli_args(**over), requires)
        except SystemExit as e:
            return ("refused", str(e.code))
        return ("ok", recipe, pcfg.pp, pcfg.pp_schedule, pcfg.microbatches,
                pcfg.recipe_kind, sorted(pcfg.features), sorted(pcfg.bugs))

    assert outcome(port_build) == outcome(jax_build)

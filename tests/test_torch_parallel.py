"""The port's distributed candidate (``repro_torch.parallel``) against the
reference's (``repro.parallel.api.make_candidate_runner`` on 8 forced host
devices), on the CPU.

* Clean candidates of reduced ``gpt-paper`` and ``tinyllama-1.1b`` under
  four parallel configs: the reference's ``compare_traces``, under the
  thresholds the reference's ``estimate_thresholds`` gives its own
  single-device trace at f32, passes the port's candidate trace against the
  JAX candidate's trace (TTrace checking its own port) and against the JAX
  reference's trace (the check a user runs).
* Each of the 13 bugs the port injects through ``parallel``: the port's
  ``ttrace_check`` gives the reference's verdict (FAIL) and localized
  module, under the first candidate of the bug-coverage matrix that covers
  the bug's ``requires``.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (configs, jax_setup, one_thread,  # noqa: E402
                           to_jax_trace, torch_model)
from repro.bugs.registry import BUGS as JAX_BUGS  # noqa: E402
from repro.core.checker import compare_traces  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.parallel import api as japi  # noqa: E402
from repro_torch.bugs.registry import BUGS, PENDING, injectable  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402

MODELS = ("gpt-paper", "tinyllama-1.1b")
CLEAN = {"dp2tp2": dict(dp=2, tp=2), "dp2tp2sp": dict(dp=2, tp=2, sp=True),
         "dp2cp2tp2sp": dict(dp=2, cp=2, tp=2, sp=True),
         "dp2tp2zero1": dict(dp=2, tp=2, zero1=True)}
# tests/test_bug_coverage_matrix.py's shard_map candidates, in its order
MATRIX = [dict(dp=2, tp=2), dict(dp=2, tp=2, sp=True),
          dict(dp=2, cp=2, tp=2), dict(dp=2, zero1=True)]
# the dense candidate's bugs (moe_router_not_synced needs an MoE arch:
# tests/test_torch_moe_parallel.py)
PARALLEL_BUGS = sorted(b for b in injectable() - {"fp8_stale_scale"}
                       if not {"pp", "moe"} & set(BUGS[b].requires))
LR = 1e-3


def setup_module():
    one_thread()


@pytest.fixture
def host_outputs(monkeypatch):
    """The reference's runner post-processes its ``shard_map`` step's
    outputs eagerly on 8-device sharded arrays (zigzag un-permute, QKV
    layout map, AdamW).  Under the suite's parallel load those small
    8-device computations can miss XLA:CPU's 40 s collective rendezvous
    and abort the process.  Hand the step's outputs over as host arrays
    (the same values, bit for bit), so the rest of the runner, unchanged,
    runs on one device."""
    step_for = japi._Plumbing.cached_shard_map

    def on_host(self, *args, **kwargs):
        fn = step_for(self, *args, **kwargs)
        return lambda *a: jax.tree.map(np.asarray, fn(*a))

    monkeypatch.setattr(japi._Plumbing, "cached_shard_map", on_host)


@functools.lru_cache(maxsize=None)
def jax_reference(name):
    """(JAX reference runner, its f32 thresholds and trace, opt state)."""
    jcfg, jm, params, named, batch = jax_setup(name)
    opt = JaxAdamW(lr=LR)
    st = opt.init(params)
    run = jax_runner(jm, params, opt, st)
    thr, trace = estimate_thresholds(run, batch, MACHINE_EPS["float32"])
    return run, thr, trace, opt, st


def port_candidate(name, pcfg):
    _, tcfg = configs(name)
    return make_candidate_runner(tcfg, pcfg, jax_setup(name)[3],
                                 AdamW(lr=LR), device="cpu")


def worst(report):
    return max(r.rel_err / r.threshold for r in report.records)


@pytest.mark.parametrize("cfg_id", sorted(CLEAN))
@pytest.mark.parametrize("name", MODELS)
def test_clean_candidate_matches_jax_candidate(forced_devices, host_outputs,
                                              name, cfg_id):
    kw = CLEAN[cfg_id]
    jcfg, _, params, _, batch = jax_setup(name)
    _, thr, jref_trace, jopt, st = jax_reference(name)
    jcand = japi.make_candidate_runner(jcfg, japi.ParallelConfig(**kw),
                                       params, jopt, st)(batch, None)
    port = to_jax_trace(port_candidate(name, ParallelConfig(**kw))(batch))
    for against, ref_trace in (("jax candidate", jcand),
                               ("jax reference", jref_trace)):
        rep = compare_traces(ref_trace, port, thr)
        print(f"{name} {cfg_id} vs {against}: {len(rep.records)} tensors, "
              f"worst rel_err/threshold {worst(rep):.3g}")
        assert rep.passed and not rep.missing, rep.summary()
        assert len(rep.records) == sum(
            len(getattr(ref_trace, s)) for s in
            ("activations", "act_grads", "param_grads", "main_grads",
             "params_post"))
    assert port.meta["fwd_order"] == jcand.meta["fwd_order"]
    assert abs(port.loss - jcand.loss) <= 1e-5 * abs(jcand.loss)


def _matrix_candidate(bug_id):
    return next(kw for kw in MATRIX
                if set(BUGS[bug_id].requires) <= ParallelConfig(**kw).features)


@pytest.mark.parametrize("bug_id", PARALLEL_BUGS)
def test_bug_gives_jax_verdict_and_module(forced_devices, host_outputs,
                                          bug_id):
    name = "gpt-paper"
    kw = _matrix_candidate(bug_id)
    jcfg, jm, params, named, batch = jax_setup(name)
    jref, _, _, jopt, st = jax_reference(name)
    bugs = frozenset([bug_id])
    jres = jax_check(jref, japi.make_candidate_runner(
        jcfg, japi.ParallelConfig(bugs=bugs, **kw), params, jopt, st), batch)
    tres = ttrace_check(
        make_model_runner(torch_model(name, named), AdamW(lr=LR),
                          device="cpu"),
        port_candidate(name, ParallelConfig(bugs=bugs, **kw)), batch)
    print(f"{bug_id} {kw}: jax {jres.passed} {jres.localized_module}, port "
          f"{tres.passed} {tres.localized_module}")
    assert not jres.passed and not tres.passed
    assert tres.localized_module == jres.localized_module


def test_injectable_bugs_are_the_reference_registry_minus_moe():
    """Since the MoE slice nothing is pending: every bug of the
    reference's registry is injectable."""
    assert injectable() == set(JAX_BUGS)
    assert set(BUGS) == set(JAX_BUGS)
    assert PENDING == {}
    assert len(PARALLEL_BUGS) == 13


@pytest.mark.parametrize("bug_id,kw,exc,match", [
    ("pp_stale_boundary", dict(pp=2, pp_schedule="1f1b", microbatches=2,
                               tp=2), ValueError, "cannot combine"),
    ("pp_wrong_stage_division", dict(pp=2, microbatches=2), ValueError,
     "1F1B pipeline only"),
    ("moe_router_not_synced", dict(dp=2), ValueError, "needs"),
])
def test_pending_bugs_are_refused_loudly(bug_id, kw, exc, match):
    """A bug the candidate cannot express refuses (the router bug without
    tp and without an MoE arch, as the reference's CLI refuses it); the pp
    candidate refuses its own bad configs (with tp, and microbatches
    without 1F1B) before any run."""
    _, tcfg = configs("gpt-paper")
    with pytest.raises(exc, match=match):
        make_candidate_runner(tcfg, ParallelConfig(bugs=frozenset([bug_id]),
                                                   **kw),
                              jax_setup("gpt-paper")[3], device="cpu")


def test_unexpressible_bug_and_pp_recipe_are_refused():
    _, tcfg = configs("gpt-paper")
    named = jax_setup("gpt-paper")[3]
    with pytest.raises(ValueError, match="needs"):
        make_candidate_runner(tcfg, ParallelConfig(
            dp=2, tp=2, bugs=frozenset(["cp_wrong_loss_scale"])), named,
            device="cpu")
    # the staged pp candidate cannot express a 1F1B schedule bug
    with pytest.raises(ValueError, match="needs"):
        make_candidate_runner(tcfg, ParallelConfig(
            pp=2, bugs=frozenset(["pp_microbatch_order"])), named,
            device="cpu")


def test_fp8_recipe_dispatches_to_the_fp8_runner():
    from repro_torch.precision.fp8 import make_fp8_runner
    _, tcfg = configs("gpt-paper")
    batch = jax_setup("gpt-paper")[4]
    a = make_candidate_runner(tcfg, ParallelConfig(fp8="tile128"),
                              jax_setup("gpt-paper")[3], device="cpu")(batch)
    b = make_fp8_runner(torch_model("gpt-paper"), "tile128",
                        device="cpu")(batch)
    for sec in ("activations", "param_grads"):
        for n in getattr(b, sec):
            assert torch.equal(getattr(a, sec).raw(n), getattr(b, sec).raw(n))


def test_two_candidate_runs_are_bit_identical():
    run = port_candidate("gpt-paper", ParallelConfig(dp=2, cp=2, tp=2,
                                                     sp=True))
    batch = jax_setup("gpt-paper")[4]
    t1, t2 = run(batch), run(batch)
    for sec in ("activations", "act_grads", "param_grads", "main_grads",
                "params_post"):
        s1, s2 = getattr(t1, sec), getattr(t2, sec)
        assert list(s1) == list(s2) and len(s1)
        for n in s1:
            assert torch.equal(s1.raw(n), s2.raw(n)), (sec, n)
    assert t1.loss == t2.loss and t1.grad_norm == t2.grad_norm


def test_candidate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = configs("gpt-paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_candidate_runner(tcfg, ParallelConfig(dp=2, tp=2),
                              jax_setup("gpt-paper")[3])


@pytest.mark.cuda
def test_card_candidate_matches_cpu_candidate():
    """One dp2·cp2·tp2·sp candidate of reduced gpt-paper in f32 on the card
    and on the CPU from the same parameters: the reference's
    ``compare_traces`` under the JAX reference's f32 thresholds passes the
    card's trace against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "gpt-paper"
    _, tcfg = configs(name)
    _, _, _, named, batch = jax_setup(name)
    _, thr, _, _, _ = jax_reference(name)
    pcfg = ParallelConfig(dp=2, cp=2, tp=2, sp=True)
    cpu = port_candidate(name, pcfg)(batch)
    card = make_candidate_runner(tcfg, pcfg, named, AdamW(lr=LR))(batch)
    rep = compare_traces(to_jax_trace(cpu), to_jax_trace(card), thr)
    print(f"card vs CPU: worst rel_err/threshold {worst(rep):.3g}")
    assert rep.passed and not rep.missing, rep.summary()
    assert np.isfinite(card.loss)

"""The port's supervised loop end to end, on the CPU.

* a clean dp2·tp2 run PASSes every step; overlapped equals lockstep bit
  for bit (pending threshold epochs, background spill and checkpoints);
* ``examples/supervised_run.py``'s configuration (reduced ``gpt-paper``, 2
  layers, vocab 512, ``zero_skipped_update`` at lr 1e-7, 16 steps, a check
  every 2 and a checkpoint every 4): the single-step verdict, the first
  flagged step, the first bad step and the localized module equal the JAX
  Supervisor's on the same parameters and batches;
* every injectable bug flags and localizes under supervision (the
  reference's supervised coverage matrix, its candidates and its config);
* crash and resume, in process and through the CLI's SIGKILL, converge
  with the uninterrupted run; a flagged run resumes to the same first bad
  step; each registered fault is injected, detected and recovered (the
  reference's matrix, reduced ``tinyllama-1.1b``).
"""
import dataclasses
import fnmatch
import functools
import os
import shutil
import signal
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.bugs.registry import BUGS, injectable  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import ParallelConfig  # noqa: E402
from repro_torch.supervise import (FAULTS, Journal, JournalState,  # noqa: E402
                                   SuperviseConfig, Supervisor, journal_path,
                                   make_injector)
from repro_torch.supervise.journal import report_to_payload  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_module():
    one_thread()


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each run writes checkpoints and spills (about 0.3 GB on tinyllama):
    remove a test's own directory once it ran, so the suite's disk use
    stays one test deep per worker."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


class Boom(Exception):
    """In-process stand-in for SIGKILL at the crash site."""


def _boom():
    raise Boom("injected crash")


# the reference's supervised bug matrix's MoE arch (reduced gpt-paper with
# MoE blocks; tests/test_bug_coverage_matrix.py)
MATRIX_MOE = dict(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=0.0)


def _with_moe(cfg, moe_config):
    return dataclasses.replace(cfg, arch_type="moe",
                               moe=moe_config(**MATRIX_MOE))


@functools.lru_cache(maxsize=None)
def jax_params(name, n_layers, vocab, moe=False):
    """The JAX package's reduced config (with the matrix's MoE blocks if
    ``moe``), its ``Model.init(PRNGKey(0))`` parameters as numpy, and its
    batch generator."""
    from repro.configs.base import MoEConfig as JaxMoE
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               n_layers=n_layers, vocab=vocab,
                               tie_embeddings=True)
    if moe:
        jcfg = _with_moe(jcfg, JaxMoE)
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    return jcfg, jm, params, named


def jax_batch_fn(jcfg, B, S):
    """Step -> the JAX package's batch as numpy (both sides feed on it)."""
    @functools.lru_cache(maxsize=None)
    def batch(step):
        return {k: np.asarray(v) for k, v in jax_make_batch(
            jcfg, B, S, seed=0, step=step).items()}
    return batch


def port_supervisor(work_dir, name="gpt-paper", n_layers=2, vocab=256,
                    bugs=(), pcfg_kw=None, lr=1e-3, B=2, S=16, fault=None,
                    moe=False, **scfg):
    from repro_torch.configs.base import MoEConfig
    jcfg, _, _, named = jax_params(name, n_layers, vocab, moe)
    cfg = dataclasses.replace(get_config(name).reduced(), n_layers=n_layers,
                              vocab=vocab, tie_embeddings=True)
    if moe:
        cfg = _with_moe(cfg, MoEConfig)
    pcfg = ParallelConfig(bugs=frozenset(bugs),
                          **(pcfg_kw or dict(dp=2, tp=2)))
    return Supervisor(Model(cfg, device="cpu"), cfg, pcfg, AdamW(lr=lr),
                      params=named,
                      scfg=SuperviseConfig(work_dir=str(work_dir), **scfg),
                      batch_fn=jax_batch_fn(jcfg, B, S), fault=fault,
                      device="cpu")


def _records(res):
    return {k: report_to_payload(v) for k, v in res.checks.items()}


def _same_state(s1, s2):
    from repro_torch.checkpoint.store import flatten_named as tflat
    a, b = tflat(s1), tflat(s2)
    assert list(a) == list(b)
    for n in a:
        if isinstance(a[n], torch.Tensor):
            assert torch.equal(a[n], b[n]), n
        else:
            assert a[n] == b[n], n


# ---------------------------------------------------------------------------
# clean runs: PASS, and overlapped == lockstep
# ---------------------------------------------------------------------------

def test_clean_dp2tp2_run_passes_every_step(tmp_path):
    sup = port_supervisor(tmp_path, steps=5, ring_window=2)
    res = sup.run()
    assert res.passed, res.summary()
    assert sorted(res.checks) == list(range(5)) and res.steps_run == 5
    assert all(rep.passed for rep in res.checks.values())
    assert sup.ring.window == 3 and sup.ring.in_memory == [2, 3, 4]
    assert sup.ring.on_disk == [0, 1] and sup.pipe.max_in_flight <= 2
    assert [t["step"] for t in res.timings["steps"]] == list(range(5))


def test_overlapped_run_is_bit_identical_to_lockstep(tmp_path):
    runs = {}
    for overlap in (True, False):
        sup = port_supervisor(tmp_path / str(overlap), steps=6,
                              reestimate_every=2, overlap=overlap)
        runs[overlap] = (sup, sup.run())
    (s1, r1), (s2, r2) = runs[True], runs[False]
    assert r1.passed and r2.passed and r1.reestimations == 2
    assert r1.losses == r2.losses and r1.cand_losses == r2.cand_losses
    assert _records(r1) == _records(r2)
    e1, e2 = s1.pipe._epochs, s2.pipe._epochs
    assert [(s, t.per_tensor, m) for s, t, m in e1] == \
        [(s, t.per_tensor, m) for s, t, m in e2]
    assert s1.ring.on_disk == s2.ring.on_disk
    assert s1.keeper.steps == s2.keeper.steps
    _same_state(s1.state, s2.state)


# ---------------------------------------------------------------------------
# the late-visible bug against the JAX Supervisor
# ---------------------------------------------------------------------------

LATE = dict(n_layers=2, vocab=512, B=4, S=32)
LATE_LR = 1e-7
LATE_BUG = "zero_skipped_update"
LATE_SCFG = dict(steps=16, check_every=2, ckpt_every=4)


def _host_candidate(cand):
    """The JAX candidate step with its outputs handed to the host: no
    eager multi-device computation after the step (XLA:CPU's collective
    rendezvous can time out under the suite's parallel load)."""
    step = cand.step

    def on_host(p, s, b):
        tr, p, s = step(p, s, b)
        tr.host()
        tr.loss, tr.grad_norm = float(tr.loss), float(tr.grad_norm)
        return (tr, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))

    return dataclasses.replace(cand, step=on_host)


def jax_late_run(work_dir):
    from repro.core.harness import make_model_runner, ttrace_check
    from repro.optim.adamw import AdamW as JaxAdamW
    from repro.parallel import api as japi
    from repro.supervise import CandidateStep
    from repro.supervise import SuperviseConfig as JSC
    from repro.supervise import Supervisor as JSup
    jcfg, jm, params, _ = jax_params("gpt-paper", LATE["n_layers"],
                                     LATE["vocab"])
    pcfg = japi.ParallelConfig(dp=2, tp=2, zero1=True,
                               bugs=frozenset([LATE_BUG]))
    batch_fn = jax_batch_fn(jcfg, LATE["B"], LATE["S"])
    opt = JaxAdamW(lr=LATE_LR)
    step_for = japi._Plumbing.cached_shard_map

    def on_host(self, *args, **kwargs):
        # the one-shot runner post-processes its step's outputs eagerly:
        # hand them over as host arrays (test_torch_parallel's host_outputs)
        fn = step_for(self, *args, **kwargs)
        return lambda *a: jax.tree.map(np.asarray, fn(*a))

    with mock.patch.object(japi._Plumbing, "cached_shard_map", on_host):
        one = ttrace_check(
            make_model_runner(jm, params, opt, opt.init(params)),
            japi.make_candidate_runner(jcfg, pcfg, params, opt,
                                       opt.init(params)),
            batch_fn(0), localize=False)
    cand = _host_candidate(CandidateStep.build(jcfg, pcfg, params, opt,
                                               batch_fn(0)))
    sup = JSup(jm, jcfg, pcfg, JaxAdamW(lr=LATE_LR), params=params,
               scfg=JSC(work_dir=work_dir, **LATE_SCFG), batch_fn=batch_fn,
               candidate=cand)
    return one.passed, sup.run()


def test_late_visible_bug_matches_the_jax_supervisor(forced_devices,
                                                    tmp_path):
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.parallel.api import make_candidate_runner
    j_one, jres = jax_late_run(str(tmp_path / "jax"))
    sup = port_supervisor(tmp_path / "port",
                          bugs=[LATE_BUG], pcfg_kw=dict(dp=2, tp=2,
                                                        zero1=True),
                          lr=LATE_LR, n_layers=LATE["n_layers"],
                          vocab=LATE["vocab"], B=LATE["B"], S=LATE["S"],
                          **LATE_SCFG)
    opt = AdamW(lr=LATE_LR)
    one = ttrace_check(
        make_model_runner(sup.model, opt, device="cpu"),
        make_candidate_runner(sup.cfg, sup.pcfg, sup.model, opt,
                              device="cpu"),
        sup.batch_fn(0), localize=False)
    res = sup.run()
    assert one.passed == j_one is True           # the single step is blind
    assert res.flagged and jres.flagged
    assert res.first_flagged_step == jres.first_flagged_step >= 1
    assert res.first_bad_step == jres.first_bad_step
    assert res.first_bad_step <= res.first_flagged_step
    assert res.localized_module == jres.localized_module


# ---------------------------------------------------------------------------
# the supervised coverage matrix (the port's injectable bugs)
# ---------------------------------------------------------------------------

# (pcfg kwargs, MoE arch), in the reference matrix's order
MATRIX = [(dict(dp=2, tp=2), False), (dict(dp=2, tp=2, sp=True), False),
          (dict(dp=2, cp=2, tp=2), False), (dict(dp=2, zero1=True), False),
          (dict(tp=2), True),
          (dict(pp=2), False),
          (dict(pp=2, pp_schedule="1f1b", microbatches=2), False),
          (dict(fp8="tile128"), False)]


@pytest.mark.parametrize("bug", sorted(injectable()))
def test_bug_flagged_and_localized_under_supervision(tmp_path, bug):
    spec = BUGS[bug]
    kw, moe = next(
        (k, moe) for k, moe in MATRIX
        if set(spec.requires) <= (ParallelConfig(**k).features
                                  | ({"moe"} if moe else set())))
    # the reference's matrix: pipeline recipes at 4 layers and B 4
    pp = "pp" in spec.requires
    res = port_supervisor(tmp_path, bugs=[bug], pcfg_kw=kw, steps=3,
                          ckpt_every=2, n_layers=4 if pp else 2,
                          B=4 if pp else 2, moe=moe).run()
    assert res.flagged and res.first_bad_step is not None, res.summary()
    loc = res.localized_module or "-"
    assert (spec.expected_module == "loss"
            or fnmatch.fnmatchcase(loc, spec.expected_module)
            or (loc == "optimizer" and "update" in spec.impact)), (
        loc, spec.expected_module)


# ---------------------------------------------------------------------------
# fault tolerance (reduced tinyllama-1.1b, the reference's matrix)
# ---------------------------------------------------------------------------

def _fresh(work_dir, fault=None, bugs=(), zero1=False, **overrides):
    kw = dict(steps=8, check_every=1, async_window=2, ckpt_every=2, seed=0)
    kw.update(overrides)
    return port_supervisor(work_dir, name="tinyllama-1.1b", n_layers=2,
                           vocab=512, bugs=bugs,
                           pcfg_kw=dict(dp=2, tp=2, zero1=zero1), B=4, S=32,
                           fault=fault, **kw)


_BASELINE = {}


def _baseline(tmp_path_factory):
    """The uninterrupted run the crash cases converge to (once a worker)."""
    if not _BASELINE:
        sup = _fresh(tmp_path_factory.mktemp("base"), reestimate_every=3,
                     stop_on_flag=False)
        _BASELINE["run"] = (sup.run(), sup.state)
        shutil.rmtree(sup.work_dir, ignore_errors=True)
    return _BASELINE["run"]


@pytest.mark.parametrize("crash_step", [2, 5])
def test_crash_resume_converges_with_uninterrupted(tmp_path_factory, tmp_path,
                                                   crash_step):
    base, base_state = _baseline(tmp_path_factory)
    wd = tmp_path
    sup = _fresh(wd, reestimate_every=3, stop_on_flag=False,
                 fault=make_injector("crash", crash_step,
                                     crash_handler=_boom))
    with pytest.raises(Boom):
        sup.run()
    again = _fresh(wd, reestimate_every=3, stop_on_flag=False)
    res = again.resume()
    assert res.resumed_from is not None and res.resumed_from <= crash_step
    assert res.steps_run == base.steps_run
    assert _records(res) == _records(base)
    assert res.reestimations == base.reestimations
    assert res.flagged == base.flagged
    _same_state(again.state, base_state)


def test_resume_refuses_drifted_config(tmp_path):
    j = Journal(journal_path(str(tmp_path)))
    j.append("start", steps=8, check_every=2, async_window=2, ckpt_every=2,
             reestimate_every=0, seed=0, drift_alpha=0.125)
    j.close()
    with pytest.raises(ValueError, match="drifted config"):
        _fresh(tmp_path).resume()


def test_flagged_run_resumes_to_same_first_bad_step(tmp_path):
    kw = dict(bugs={"zero_skipped_update"}, zero1=True, steps=8)
    base = _fresh(tmp_path / "base", **kw).run()
    assert base.flagged and base.localized_module == "optimizer"
    wd = tmp_path / "crash"
    sup = _fresh(wd, fault=make_injector("crash", 2, crash_handler=_boom),
                 **kw)
    try:
        sup.run()
    except Boom:
        pass        # stop_on_flag may resolve the flag before step 2 fires
    res = _fresh(wd, **kw).resume()
    assert res.flagged
    assert res.first_flagged_step == base.first_flagged_step
    assert res.first_bad_step == base.first_bad_step
    assert res.localized_module == base.localized_module


@pytest.mark.parametrize("fault_id", sorted(FAULTS))
def test_every_fault_is_injected_detected_and_recovered(fault_id, tmp_path):
    wd = str(tmp_path)
    if fault_id == "crash":
        sup = _fresh(wd, steps=6, fault=make_injector(
            "crash", 3, crash_handler=_boom))
        with pytest.raises(Boom):
            sup.run()
        assert sup.fault.fired == 1
        assert any(e["t"] == "start" for e in Journal.read(journal_path(wd)))
        res = _fresh(wd, steps=6).resume()
        assert res.steps_run == 6 and res.passed
        assert res.resumed_from is not None
    elif fault_id == "hang_check":
        res = _fresh(wd, steps=8, stop_on_flag=False, watchdog_timeout_s=0.3,
                     watchdog_retries=0, degrade_after=2,
                     fault=make_injector("hang_check", 2)).run()
        assert res.steps_run == 8 and res.checks_rescued > 0
        assert res.degradations and res.degraded_check_every > 1
        assert res.passed
    elif fault_id == "nan_step":
        res = _fresh(wd, steps=6, fault=make_injector("nan_step", 2)).run()
        assert 2 in res.loud_steps and res.flagged
        assert res.first_bad_step == 2 and "LOUD" in res.summary()
    elif fault_id == "corrupt_spill":
        sup = _fresh(wd, steps=8, stop_on_flag=False,
                     fault=make_injector("corrupt_spill", 1))
        assert sup.run().steps_run == 8
        with pytest.raises(KeyError, match="corrupt"):
            sup.ring.get(1)
        assert sup.ring.corrupt_count == 1
    elif fault_id == "truncate_ckpt":
        sup = _fresh(wd, steps=6, stop_on_flag=False,
                     fault=make_injector("truncate_ckpt", 2))
        assert sup.run().steps_run == 6
        assert sup.keeper.verify(0) and not sup.keeper.verify(2)
        assert sup._params_diverged(2) is True
        assert 2 not in sup.keeper.steps
        assert any("corrupt checkpoint" in e.detail
                   for e in sup.watchdog.events)
    elif fault_id == "dead_spill_writer":
        sup = _fresh(wd, steps=8, stop_on_flag=False,
                     fault=make_injector("dead_spill_writer", 1))
        res = sup.run()
        assert res.steps_run == 8
        assert any("spill writer" in e for e in res.watchdog_events)
        assert sup.ring.drop_count >= 1 and sup.ring.spill_count >= 1
    else:
        pytest.fail(f"no matrix case for registered fault {fault_id!r}")


def test_truncated_ckpt_replay_falls_back_to_earlier_checkpoint(tmp_path):
    sup = _fresh(str(tmp_path), steps=6, stop_on_flag=False,
                 fault=make_injector("truncate_ckpt", 4))
    assert sup.run().steps_run == 6 and not sup.keeper.verify(4)
    n_events = len(sup.watchdog.events)
    assert sup._replay(4, 5) is None
    assert 4 not in sup.keeper.steps
    assert any("corrupt checkpoint at replay" in e.detail
               for e in sup.watchdog.events[n_events:])


def test_cli_sigkill_then_resume_converges(tmp_path):
    """A true SIGKILL through the CLI's fault harness, then ``--resume``:
    the journaled verdicts equal an uninterrupted CLI run's."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    common = [sys.executable, "-m", "repro_torch.launch.supervise",
              "--reduced", "--steps", "6", "--ckpt-every", "2",
              "--device", "cpu"]
    wd, whole = str(tmp_path / "run"), str(tmp_path / "whole")
    out = subprocess.run(common + ["--work-dir", wd, "--fault", "crash",
                                   "--fault-step", "4"],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert out.returncode == -signal.SIGKILL, out.stdout + out.stderr
    for extra in (["--work-dir", wd, "--resume"], ["--work-dir", whole]):
        out = subprocess.run(common + extra, capture_output=True, text=True,
                             timeout=600, env=env, cwd=ROOT)
        assert out.returncode == 0, out.stdout + "\n" + out.stderr
        assert "PASS" in out.stdout
        assert ("resumed from journaled checkpoint" in out.stdout) == (
            "--resume" in extra)
    verdicts = [{k: report_to_payload(v) for k, v in JournalState(
        Journal.read(journal_path(d))).verdicts.items()} for d in (wd, whole)]
    assert verdicts[0] == verdicts[1] and len(verdicts[0]) == 6

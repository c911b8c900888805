"""The port's expert-parallel MoE candidate (``parallel/gpt.tp_moe``) and
its Supervisor against the JAX package's, on the CPU.

The model is the reference's supervised bug matrix's MoE setup
(``tests/test_bug_coverage_matrix.py``): reduced ``gpt-paper``, 2 layers,
vocab 256, tied embeddings, 4 experts of d_ff 128, top 2, dropless.

* tp2, tp2·sp and dp2·tp2 candidates: the reference's ``compare_traces``,
  under the thresholds the reference's ``estimate_thresholds`` gives its
  own single-device trace at f32, passes the port's candidate trace
  against the JAX candidate's and against the JAX reference's.
* ``moe_router_not_synced`` (paper bug 6) at tp2: the port's check gives
  the JAX check's verdict and module, and the port's Supervisor the JAX
  Supervisor's flagged step, first bad step and module.
* The reference's distributed attention is causal only (its
  ``_cp_attention_math`` ignores the sliding window, and the port copies
  it): on reduced ``mixtral-8x7b`` at S 128, twice its window of 64, both
  packages' clean tp2 candidates get the same verdict against their
  single-device reference, and at S 64 both PASS.

Few and small: every case runs the JAX candidate under ``shard_map`` on
the forced host devices, whose rendezvous can abort a worker under the
suite's parallel load; ``host_outputs`` hands the JAX step's outputs over
as host arrays (as ``tests/test_torch_parallel.py`` does).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (configs, jax_setup, one_thread,  # noqa: E402
                           to_jax_trace)
from repro.configs.base import MoEConfig as JaxMoE  # noqa: E402
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
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402
from repro_torch.supervise import SuperviseConfig, Supervisor  # noqa: E402

CLEAN = {"tp2": dict(tp=2), "tp2sp": dict(tp=2, sp=True),
         "dp2tp2": dict(dp=2, tp=2)}
BUG = "moe_router_not_synced"
LR = 1e-3
B, S = 2, 16
SUP_SCFG = dict(steps=3, ckpt_every=2)


def setup_module():
    one_thread()


@pytest.fixture
def host_outputs(monkeypatch):
    """The JAX runner's ``shard_map`` step outputs as host arrays (the same
    values), so its eager post-processing runs on one device."""
    step_for = japi._Plumbing.cached_shard_map

    def on_host(self, *args, **kwargs):
        fn = step_for(self, *args, **kwargs)
        return lambda *a: jax.tree.map(np.asarray, fn(*a))

    monkeypatch.setattr(japi._Plumbing, "cached_shard_map", on_host)


def moe_configs():
    """Both packages' bug-matrix MoE config."""
    kw = dict(n_layers=2, vocab=256, tie_embeddings=True, arch_type="moe")
    moe = dict(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=0.0)
    return (dataclasses.replace(jax_get_config("gpt-paper").reduced(),
                                moe=JaxMoE(**moe), **kw),
            dataclasses.replace(get_config("gpt-paper").reduced(),
                                moe=MoEConfig(**moe), **kw))


@functools.lru_cache(maxsize=None)
def jax_moe_setup():
    """(jax cfg, port cfg, jax model, params, numpy named params, batch,
    the JAX reference runner, its f32 thresholds and trace)."""
    jcfg, tcfg = moe_configs()
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v)
             for k, v in jax_make_batch(jcfg, B, S).items()}
    opt = JaxAdamW(lr=LR)
    run = jax_runner(jm, params, opt, opt.init(params))
    thr, trace = estimate_thresholds(run, batch, MACHINE_EPS["float32"])
    return jcfg, tcfg, jm, params, named, batch, run, thr, trace


def port_model(tcfg, named):
    return params_from_jax(named, Model(tcfg, device="cpu"))


def worst(report):
    return max(r.rel_err / r.threshold for r in report.records)


@pytest.mark.parametrize("cfg_id", sorted(CLEAN))
def test_clean_moe_candidate_matches_jax(forced_devices, host_outputs,
                                         cfg_id):
    kw = CLEAN[cfg_id]
    jcfg, tcfg, _, params, named, batch, _, thr, jref = jax_moe_setup()
    opt = JaxAdamW(lr=LR)
    jcand = japi.make_candidate_runner(jcfg, japi.ParallelConfig(**kw),
                                       params, opt,
                                       opt.init(params))(batch, None)
    port = to_jax_trace(make_candidate_runner(
        tcfg, ParallelConfig(**kw), named, AdamW(lr=LR),
        device="cpu")(batch))
    for against, ref_trace in (("jax candidate", jcand),
                               ("jax reference", jref)):
        rep = compare_traces(ref_trace, port, thr)
        print(f"moe {cfg_id} vs {against}: {len(rep.records)} tensors, "
              f"worst rel_err/threshold {worst(rep):.3g}")
        assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jcand.meta["fwd_order"]
    assert "layers.1.mlp/router_logits" in port.meta["fwd_order"]
    assert abs(port.loss - jcand.loss) <= 1e-5 * abs(jcand.loss)


@pytest.mark.parametrize("eps", ["float32", "bfloat16"])
def test_router_bug_gives_jax_verdict_and_module(forced_devices,
                                                 host_outputs, eps):
    """At f32's epsilon both checks FAIL at the same ``layers.*.mlp``.  At
    bf16's, every threshold is at least 8 x 4 x 2^-8 = 12.5% relative, far
    above the drift's effect, and both PASS it (the verdict the card's
    full-width phase 22b measures)."""
    jcfg, tcfg, _, params, named, batch, jref, _, _ = jax_moe_setup()
    bugs = frozenset([BUG])
    opt = JaxAdamW(lr=LR)
    jres = jax_check(jref, japi.make_candidate_runner(
        jcfg, japi.ParallelConfig(tp=2, bugs=bugs), params, opt,
        opt.init(params)), batch, eps=MACHINE_EPS[eps])
    tres = ttrace_check(
        make_model_runner(port_model(tcfg, named), AdamW(lr=LR),
                          device="cpu"),
        make_candidate_runner(tcfg, ParallelConfig(tp=2, bugs=bugs), named,
                              AdamW(lr=LR), device="cpu"), batch,
        eps=MACHINE_EPS[eps])
    print(f"{BUG} at {eps} eps: jax {jres.passed} {jres.localized_module} "
          f"{worst(jres.report):.3g}, port {tres.passed} "
          f"{tres.localized_module} {worst(tres.report):.3g}")
    assert tres.passed == jres.passed == (eps == "bfloat16")
    assert tres.localized_module == jres.localized_module
    if eps == "float32":
        assert tres.localized_module.startswith("layers.")
        assert tres.localized_module.endswith(".mlp")


def _host_candidate(cand):
    """The JAX candidate step with its outputs handed to the host."""
    step = cand.step

    def on_host(p, s, b):
        tr, p, s = step(p, s, b)
        tr.host()
        tr.loss, tr.grad_norm = float(tr.loss), float(tr.grad_norm)
        return (tr, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s))

    return dataclasses.replace(cand, step=on_host)


def test_router_bug_under_supervision_matches_jax(forced_devices, tmp_path):
    from repro.supervise import CandidateStep
    from repro.supervise import SuperviseConfig as JSC
    from repro.supervise import Supervisor as JSup
    jcfg, tcfg, jm, params, named, _, _, _, _ = jax_moe_setup()

    @functools.lru_cache(maxsize=None)
    def batch_fn(step):
        return {k: np.asarray(v) for k, v in jax_make_batch(
            jcfg, B, S, seed=0, step=step).items()}

    bugs = frozenset([BUG])
    jpcfg = japi.ParallelConfig(tp=2, bugs=bugs)
    cand = _host_candidate(CandidateStep.build(
        jcfg, jpcfg, params, JaxAdamW(lr=LR), batch_fn(0)))
    jres = JSup(jm, jcfg, jpcfg, JaxAdamW(lr=LR), params=params,
                scfg=JSC(work_dir=str(tmp_path / "jax"), **SUP_SCFG),
                batch_fn=batch_fn, candidate=cand).run()
    res = Supervisor(Model(tcfg, device="cpu"), tcfg,
                     ParallelConfig(tp=2, bugs=bugs), AdamW(lr=LR),
                     params=named,
                     scfg=SuperviseConfig(work_dir=str(tmp_path / "port"),
                                          **SUP_SCFG),
                     batch_fn=batch_fn, device="cpu").run()
    print(f"supervised {BUG}: jax {jres.first_flagged_step} "
          f"{jres.first_bad_step} {jres.localized_module}; port "
          f"{res.first_flagged_step} {res.first_bad_step} "
          f"{res.localized_module}")
    assert res.flagged and jres.flagged
    assert res.first_flagged_step == jres.first_flagged_step
    assert res.first_bad_step == jres.first_bad_step
    assert res.localized_module == jres.localized_module


@pytest.mark.parametrize("seq", [64, 128])
def test_window_blind_distributed_attention_same_verdict(
        forced_devices, host_outputs, seq):
    """Reduced mixtral-8x7b (window 64): at S 64 the window equals the
    causal mask and both clean tp2 candidates PASS; at S 128 both
    packages' candidates attend past the window, and their verdicts
    against their own single-device reference agree."""
    name = "mixtral-8x7b"
    jcfg, tcfg = configs(name)
    _, jm, params, named, batch = jax_setup(name, seq=seq)
    opt = JaxAdamW(lr=LR)
    jres = jax_check(
        jax_runner(jm, params, opt, opt.init(params)),
        japi.make_candidate_runner(jcfg, japi.ParallelConfig(tp=2), params,
                                   opt, opt.init(params)),
        batch, localize=False)
    tres = ttrace_check(
        make_model_runner(port_model(tcfg, named), AdamW(lr=LR),
                          device="cpu"),
        make_candidate_runner(tcfg, ParallelConfig(tp=2), named,
                              AdamW(lr=LR), device="cpu"),
        batch, localize=False)
    print(f"S {seq} (window {tcfg.window}): jax {jres.passed} "
          f"{worst(jres.report):.3g}, port {tres.passed} "
          f"{worst(tres.report):.3g}")
    assert tres.passed == jres.passed
    assert tres.passed == (seq <= tcfg.window)

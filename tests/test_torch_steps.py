"""The supervised loop's step builders against the JAX package's.

From the JAX package's parameters and batches (reduced ``gpt-paper``, 2
layers, vocab 256, B 2 x S 16), each port step builder threads its own
state through K = 4 steps: ``collector.make_trace_step`` (the reference
step), ``parallel.api.make_candidate_train_step`` for dp2·tp2·zero1 and
dp2·cp2·tp2·sp, and ``precision.fp8.make_fp8_train_step`` (tile128,
through the candidate dispatch).  At every step the reference's checker
passes the port's trace against the JAX step's trace, under the
thresholds the JAX ``make_pair_estimator`` gives the JAX reference step's
state and batch (f32 eps; fp8's eps for the fp8 step) and the reference
pipeline's supervised schedule for a re-estimated epoch
(``REESTIMATED_KIND_MULT``, growing 1/8 a step; step 0 exact): the two
packages' states drift apart by round-off from step 1 on, which is the
allowance that schedule makes.
The port's pair estimator agrees with the JAX one within ``EST_FACTOR``
on every threshold; the two draw different perturbation directions.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import configs, jax_setup, one_thread, to_jax_trace, \
    torch_model  # noqa: E402
from repro.core import canonical as JC  # noqa: E402
from repro.core.checker import compare_traces  # noqa: E402
from repro.supervise.pipeline import (REESTIMATED_KIND_MULT,  # noqa: E402
                                      AsyncCheckPipeline)
from repro.core.collector import make_trace_step as jax_make_trace_step  # noqa: E402
from repro.core.thresholds import MACHINE_EPS  # noqa: E402
from repro.core.thresholds import make_pair_estimator as jax_estimator  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.core.collector import (make_pair_collector,  # noqa: E402
                                        make_trace_step, named_params,
                                        trace_fn_pair, trace_fn_step)
from repro_torch.core.harness import inputs_on  # noqa: E402
from repro_torch.core.thresholds import make_pair_estimator  # noqa: E402
from repro_torch.optim.adamw import AdamW, warmup_cosine  # noqa: E402
from repro_torch.parallel.api import (ParallelConfig,  # noqa: E402
                                      make_candidate_train_step,
                                      make_plain_train_step)

NAME = "gpt-paper"
K = 4
LR = 1e-3
CANDIDATES = {"dp2tp2zero1": dict(dp=2, tp=2, zero1=True),
              "dp2cp2tp2sp": dict(dp=2, cp=2, tp=2, sp=True),
              "fp8-tile128": dict(fp8="tile128")}
EPS = {"reference": MACHINE_EPS["float32"],
       "dp2tp2zero1": MACHINE_EPS["float32"],
       "dp2cp2tp2sp": MACHINE_EPS["float32"],
       "fp8-tile128": MACHINE_EPS["float8_e4m3fn"]}
# the two packages perturb in independent random directions: per-tensor
# estimates agree only to within this factor
EST_FACTOR = 4.0


def setup_module():
    one_thread()


def _batches():
    jcfg = configs(NAME)[0]
    return [{k: np.asarray(v) for k, v in jax_make_batch(
        jcfg, 2, 16, seed=0, step=k).items()} for k in range(K)]


@functools.lru_cache(maxsize=None)
def jax_run():
    """The JAX reference step's K traces (host) and, per eps, the JAX pair
    estimator's thresholds at each step's state and batch."""
    _, jm, params, _, _ = jax_setup(NAME)
    batches = _batches()
    opt = JaxAdamW(lr=LR)

    def loss_call(p, b, ctx):
        return jm.loss(p, b, ctx=ctx)[0]

    step = jax_make_trace_step(loss_call, opt, params, batches[0])
    ests = {eps: jax_estimator(loss_call, opt, params, batches[0], eps)
            for eps in sorted(set(EPS.values()))}
    p, s = params, opt.init(params)
    traces, thr = [], {eps: [] for eps in ests}
    for k in range(K):
        for eps, est in ests.items():
            thr[eps].append(est(p, s, batches[k], step=k))
        tr, p, s = step(p, s, batches[k])
        tr.host()
        tr.loss, tr.grad_norm = float(tr.loss), float(tr.grad_norm)
        traces.append(tr)
    return traces, thr


@functools.lru_cache(maxsize=None)
def port_run(which):
    """The port step's K traces from the JAX parameters."""
    _, tcfg = configs(NAME)
    named = jax_setup(NAME)[3]
    opt = AdamW(lr=LR)
    if which == "reference":
        model = torch_model(NAME, named)
        params = named_params(model)

        def loss_call(b, ctx):
            return model.loss(b, ctx=ctx)[0]
        step = make_trace_step(loss_call, opt, params)
        p = {k: v.detach().clone() for k, v in params.items()}
        s = opt.init(p)
    else:
        step, p, s = make_candidate_train_step(
            tcfg, ParallelConfig(**CANDIDATES[which]), named, opt,
            device="cpu")
    traces = []
    for b in _batches():
        tr, p, s = step(p, s, inputs_on(torch.device("cpu"), b)[0])
        traces.append(to_jax_trace(tr))
    return traces


@pytest.mark.parametrize("k", range(K))
@pytest.mark.parametrize("which", ["reference", *CANDIDATES])
def test_port_step_passes_the_reference_checker(which, k):
    jax_traces, thr = jax_run()
    pipe = AsyncCheckPipeline(thr[EPS[which]][k],
                              kind_mult=REESTIMATED_KIND_MULT)
    rep = pipe.check_sync(k, jax_traces[k], port_run(which)[k]).report
    assert rep.passed, rep.summary()
    assert len(rep.records) == len(compare_traces(
        jax_traces[k], jax_traces[k], thr[EPS[which]][k]).records)


def test_pair_estimators_agree():
    """Both packages' re-estimate at step 0 (f32 eps), tensor by tensor."""
    _, thr = jax_run()
    jthr = thr[MACHINE_EPS["float32"]][0]
    model = torch_model(NAME)
    params = named_params(model)

    def loss_call(b, ctx):
        return model.loss(b, ctx=ctx)[0]

    opt = AdamW(lr=LR)
    b0 = inputs_on(torch.device("cpu"), _batches()[0])[0]
    p = {k: v.detach().clone() for k, v in params.items()}
    est = make_pair_estimator(loss_call, opt, params, b0,
                              MACHINE_EPS["float32"])
    tthr = est(p, opt.init(p), b0, step=0)
    assert set(tthr.per_tensor) == set(jthr.per_tensor)
    ratios = []
    for kind, named in jthr.per_tensor.items():
        assert set(named) == set(tthr.per_tensor[kind]), kind
        for n in named:
            a, b = jthr.threshold(kind, n), tthr.threshold(kind, n)
            ratios.append(max(a, b) / min(a, b))
    assert max(ratios) <= EST_FACTOR, max(ratios)


def _reduced_model():
    model = torch_model(NAME)

    def loss_call(b, ctx):
        return model.loss(b, ctx=ctx)[0]
    return model, loss_call


def _bitwise(t1, t2):
    from repro_torch.core.collector import SECTION_FIELDS
    for f in SECTION_FIELDS:
        s1, s2 = getattr(t1, f), getattr(t2, f)
        assert list(s1) == list(s2), f
        for n in s1:
            assert torch.equal(s1.raw(n), s2.raw(n)), (f, n)


def test_pair_collector_rows_are_two_single_runs():
    """Row i of a stacked pair equals a single traced step on batch i."""
    model, loss_call = _reduced_model()
    params = named_params(model)
    opt = AdamW(lr=LR)
    bs = [inputs_on(torch.device("cpu"), b)[0] for b in _batches()[:2]]
    t0, t1 = trace_fn_pair(loss_call, params,
                           {k: torch.stack([bs[0][k], bs[1][k]])
                            for k in bs[0]}, opt=opt)
    for b, tr in zip(bs, (t0, t1)):
        single, _, _ = trace_fn_step(loss_call, params, b, opt=opt)
        _bitwise(tr, single)
        assert tr.loss == single.loss and tr.grad_norm == single.grad_norm


def test_pair_collector_row_rewrite_applies_to_its_row_only():
    model, loss_call = _reduced_model()
    params = named_params(model)
    b = inputs_on(torch.device("cpu"), _batches()[0])[0]
    p = {k: v.detach().clone() for k, v in params.items()}
    tap = "embedding/output"
    collect = make_pair_collector(
        loss_call, None, params,
        row_rewrite=lambda row, step: {tap: lambda x: x * (1 + row)})
    t0, t1 = collect(p, None, {k: torch.stack([v, v]) for k, v in b.items()})
    assert torch.equal(t1.activations.raw(tap),
                       2 * t0.activations.raw(tap))
    single, _, _ = trace_fn_step(loss_call, params, b)
    _bitwise(t0, single)


def test_plain_train_step_matches_the_traced_step():
    """Two steps of the trace-free candidate step give the traced step's
    parameters and optimizer state bit for bit."""
    _, tcfg = configs(NAME)
    named = jax_setup(NAME)[3]
    pcfg = ParallelConfig(dp=2, tp=2, zero1=True,
                          bugs=frozenset(["zero_skipped_update"]))
    opt = AdamW(lr=LR)
    traced, p1, s1 = make_candidate_train_step(tcfg, pcfg, named, opt,
                                               device="cpu")
    plain, prep, p2, s2 = make_plain_train_step(tcfg, pcfg, named, opt,
                                                device="cpu")
    for b in _batches()[:2]:
        tr, p1, s1 = traced(p1, s1, inputs_on(torch.device("cpu"), b)[0])
        p2, s2, loss = plain(p2, s2, prep(b))
        assert float(loss) == float(tr.loss)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["m"][k], s2["m"][k]), k
    assert s1["step"] == s2["step"] == 2


def test_steps_update_nothing_in_place():
    """A trace and a state handed out by a step keep their values after
    later steps: the ring, the spill and the bisection replay rely on it."""
    _, tcfg = configs(NAME)
    named = jax_setup(NAME)[3]
    step, p, s = make_candidate_train_step(
        tcfg, ParallelConfig(dp=2, tp=2, zero1=True), named, AdamW(lr=LR),
        device="cpu")
    bs = [inputs_on(torch.device("cpu"), b)[0] for b in _batches()]
    tr0, p1, s1 = step(p, s, bs[0])
    kept = {(f, n): getattr(tr0, f).raw(n).clone()
            for f in ("activations", "param_grads", "params_post")
            for n in getattr(tr0, f)}
    p_kept = {k: v.clone() for k, v in p1.items()}
    step(p1, s1, bs[1])
    for (f, n), v in kept.items():
        assert torch.equal(getattr(tr0, f).raw(n), v), (f, n)
    for k, v in p_kept.items():
        assert torch.equal(p1[k], v), k


@pytest.mark.parametrize("step", [0, 3, 10, 55, 99, 150])
def test_warmup_cosine_matches_the_reference(step):
    a = warmup_cosine(3e-4, 10, 100)(step)
    b = float(jax_warmup_cosine(3e-4, 10, 100)(np.int32(step)))
    assert a == pytest.approx(b, rel=1e-6)


def test_callable_lr_and_loss_scale():
    """AdamW with a schedule and a loss scale: the scaled gradients give
    the unscaled update, and the schedule's lr at each step is used."""
    g = {"w": torch.randn(5, 3, generator=torch.Generator().manual_seed(0))}
    p = {"w": torch.ones(5, 3)}
    sched = warmup_cosine(1e-2, 2, 10)
    opt = AdamW(lr=sched)
    st = opt.init(p)
    p1, st1, info = opt.update(p, {"w": g["w"] * 4}, st, loss_scale=4.0)
    p2, _, info2 = opt.update(p, g, st)
    assert torch.equal(p1["w"], p2["w"]) and info.lr == sched(0)
    assert info.loss_scale == 4.0 and info2.loss_scale == 1.0
    _, _, info3 = opt.update(p1, g, st1)
    assert info3.lr == sched(1)

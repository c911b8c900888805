"""The training step and driver against the JAX package's.

``launch.steps.make_train_step`` runs three steps from the JAX package's
parameters and batches (reduced ``gpt-paper`` and ``tinyllama-1.1b``, 2
layers, vocab 256, B 4 x S 16, a warmup-cosine lr) at ``n_micro`` 1 and 2
beside the JAX step: ``loss``, ``grad_norm`` and ``lr`` agree at rtol
1e-5 (measured: 3.6e-7 at most), and every parameter and every
``master`` / ``m`` / ``v`` leaf after step 3 lies within a normwise
rel-err of ``STATE_TOL`` of the JAX one.  Measured on the CPU, the
largest is 2.49e-5 (tinyllama's ``v.layers.1.mlp.down.w`` at
``n_micro`` 2); at ``n_micro`` 1, where the two steps differ only by the
packages' round-off, it is already 1.96e-5, so 1e-5 is below what two
f32 implementations give over three Adam steps (``m / sqrt(v)`` turns a
gradient entry near zero into a whole update of either sign).  At ``n_micro`` 1 the step
is bit-identical to ``collector.make_trace_step``.  ``default_n_micro``,
``input_specs`` and ``cache_specs`` agree with the reference's; resume
is bit-identical at the step level; the CLI trains, checks, saves and
resumes on the CPU, and the JAX package reads its checkpoint.  With
``remat`` on (``scan_layers`` set, as the full configs have them) two
steps are bit-identical to ``remat`` off under both policies, and a
collecting trace is unchanged.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import configs, jax_setup, one_thread, \
    torch_model  # noqa: E402
from repro.checkpoint.store import \
    load_checkpoint_named as jax_load_named  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.collector import flatten_named as jax_flatten  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.optim.adamw import warmup_cosine as jax_warmup  # noqa: E402
from repro_torch.checkpoint.store import (flatten_named,  # noqa: E402
                                          load_checkpoint, save_checkpoint)
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.collector import (SECTION_FIELDS,  # noqa: E402
                                        make_trace_step, named_params,
                                        to_numpy, trace_train_step)
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.core.harness import inputs_on  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW, warmup_cosine  # noqa: E402

NAMES = ("gpt-paper", "tinyllama-1.1b")
B, S, STEPS = 4, 16, 3
LR = (1e-3, 1, STEPS)          # warmup_cosine(base, warmup, total)
STATE_TOL = 5e-5              # twice the largest measured
SPEC_CONFIGS = ("tinyllama-1.1b", "mixtral-8x7b", "deepseek-v2-236b",
                "rwkv6-7b", "zamba2-7b", "llava-next-34b", "hubert-xlarge")
DTYPES = {"int32": torch.int64, "float32": torch.float32,
          "bfloat16": torch.bfloat16, "bool": torch.bool}


def setup_module():
    one_thread()


def _batches(name):
    jcfg = configs(name)[0]
    return [{k: np.asarray(v) for k, v in jax_make_batch(
        jcfg, B, S, seed=0, step=k).items()} for k in range(STEPS)]


def _normwise(a, b) -> float:
    a = np.asarray(a, np.float64)
    d = np.linalg.norm(a - np.asarray(b, np.float64))
    na = np.linalg.norm(a)
    return float(d / na) if na > 0 else float(d)


@functools.lru_cache(maxsize=None)
def jax_run(name, n_micro):
    """The JAX step's metrics and final (params, opt state), flat numpy."""
    _, jm, params, _, _ = jax_setup(name)
    opt = JaxAdamW(lr=jax_warmup(*LR))
    step = jax.jit(JS.make_train_step(jm, opt, n_micro=n_micro))
    p, s = params, opt.init(params)
    metrics = []
    for b in _batches(name):
        p, s, m = step(p, s, b)
        metrics.append({k: float(v) for k, v in m.items()})
    state = {"params": p, **{k: s[k] for k in ("master", "m", "v")}}
    return metrics, {k: np.asarray(v) for k, v in jax_flatten(state).items()}


def _port_start(name):
    model = torch_model(name)
    params = {k: p.detach().clone() for k, p in named_params(model).items()}
    return model, params


def port_run(name, n_micro):
    model, p = _port_start(name)
    opt = AdamW(lr=warmup_cosine(*LR))
    step = TS.make_train_step(model, opt, n_micro=n_micro)
    s = opt.init(p)
    metrics = []
    for b in _batches(name):
        p, s, m = step(p, s, inputs_on(torch.device("cpu"), b)[0])
        metrics.append({k: float(v) for k, v in m.items()})
    state = {"params": p, **{k: s[k] for k in ("master", "m", "v")}}
    return metrics, flatten_named(state), s["step"]


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_the_reference(name, n_micro):
    jm, js = jax_run(name, n_micro)
    tm, ts, step = port_run(name, n_micro)
    assert step == STEPS
    assert [sorted(m) for m in tm] == [sorted(m) for m in jm]
    assert sorted(tm[0]) == ["aux", "ce", "grad_norm", "loss", "lr"]
    for t, j in zip(tm, jm):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    assert set(ts) == set(js)
    errs = {k: _normwise(js[k], ts[k].numpy()) for k in js}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= STATE_TOL, (worst, errs[worst])


class _Capture(AdamW):
    """AdamW that keeps the gradients its last update was given."""

    def update(self, params, grads, state, loss_scale=None):
        self.grads = grads
        return super().update(params, grads, state, loss_scale)


def test_microbatches_split_the_batch_in_order():
    """n_micro 2 hands the optimizer (g(first half) + g(second half)) / 2
    in f32, bit for bit, and reports the mean of the halves' losses."""
    name = "gpt-paper"
    b = inputs_on(torch.device("cpu"), _batches(name)[0])[0]
    opt = _Capture()
    model, p = _port_start(name)
    _, _, m2 = TS.make_train_step(model, opt, n_micro=2)(p, opt.init(p), b)
    g2 = opt.grads
    halves = []
    for i in range(2):
        _, _, m1 = TS.make_train_step(model, opt)(
            p, opt.init(p), {k: v[2 * i:2 * i + 2] for k, v in b.items()})
        halves.append((opt.grads, m1))
    assert set(g2) == set(halves[0][0])
    for k, g in g2.items():
        assert g.dtype == torch.float32
        want = (torch.zeros_like(g) + halves[0][0][k].float()
                + halves[1][0][k].float()) / 2
        assert torch.equal(g, want), k
    for key in ("loss", "ce", "aux"):
        assert torch.equal(m2[key], torch.stack(
            [halves[0][1][key], halves[1][1][key]]).mean()), key


def test_single_microbatch_is_bit_identical_to_the_trace_step():
    name = "tinyllama-1.1b"
    opt = AdamW(lr=warmup_cosine(*LR))
    model, p0 = _port_start(name)
    leaves = named_params(model)
    trace_step = make_trace_step(lambda b, ctx: model.loss(b, ctx=ctx)[0],
                                 opt, leaves)
    train_step = TS.make_train_step(model, opt)
    pa, sa = p0, opt.init(p0)
    pb, sb = p0, opt.init(p0)
    for b in _batches(name):
        b = inputs_on(torch.device("cpu"), b)[0]
        _, pa, sa = trace_step(pa, sa, b)
        pb, sb, _ = train_step(pb, sb, b)
    fa, fb = flatten_named((pa, sa)), flatten_named((pb, sb))
    assert list(fa) == list(fb)
    diff = [k for k in fa if not (torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]
    assert not diff, diff[:5]


def _remat_model(name, **kw):
    """The reduced model rebuilt with ``kw`` set on its config (the reduced
    config scans nothing), loaded with the reference's parameters."""
    cfg = dataclasses.replace(configs(name)[1], **kw)
    return params_from_jax(jax_setup(name)[3], Model(cfg, device="cpu"))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_identical(policy):
    """Two steps at ``n_micro`` 2 with ``remat`` on (``scan_layers``, the
    reference's condition) and off give the same params, opt state and
    metrics bit for bit; remat recomputes (more flops), and a collecting
    trace, which keeps its taps and does not remat, is unchanged."""
    from torch.utils.flop_counter import FlopCounterMode
    name = "tinyllama-1.1b"
    batches = [inputs_on(torch.device("cpu"), b)[0] for b in _batches(name)]
    runs, flops, traces = {}, {}, {}
    for remat in (False, True):
        model = _remat_model(name, scan_layers=True, remat=remat,
                             remat_policy=policy)
        assert [s.scan for s in model.plan] == [True]
        opt = AdamW(lr=warmup_cosine(*LR))
        p = {k: v.detach().clone() for k, v in named_params(model).items()}
        st = opt.init(p)
        step = TS.make_train_step(model, opt, n_micro=2)
        out = []
        for i, b in enumerate(batches[:2]):
            with FlopCounterMode(display=False) as fc:
                p, st, m = step(p, st, b)
            out.append(m)
        flops[remat] = fc.get_total_flops()
        runs[remat] = flatten_named((p, st, out))
        traces[remat] = trace_train_step(model, batches[0])[0]
    assert flops[True] > flops[False]
    a, b = runs[False], runs[True]
    assert list(a) == list(b)
    diff = [k for k in a if not (torch.equal(a[k], b[k])
                                 if isinstance(a[k], torch.Tensor)
                                 else a[k] == b[k])]
    assert not diff, diff[:5]
    for f in SECTION_FIELDS:
        ta, tb = getattr(traces[False], f), getattr(traces[True], f)
        assert list(ta) == list(tb), f
        assert all(np.array_equal(to_numpy(ta[k]), to_numpy(tb[k]))
                   for k in ta), f


def test_a_batch_that_does_not_split_is_refused():
    model, p = _port_start("gpt-paper")
    opt = AdamW()
    b = inputs_on(torch.device("cpu"), _batches("gpt-paper")[0])[0]
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(model, opt, n_micro=3)(p, opt.init(p), b)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def test_default_n_micro_matches_the_reference():
    """Where one sequence a microbatch is over the budget, the reference's
    divisor search never ends; the port answers the local batch there."""
    for name in ("gpt-paper", "tinyllama-1.1b", "qwen1.5-110b",
                 "deepseek-v2-236b", "zamba2-7b"):
        cfg = get_config(name)
        for key, shape in INPUT_SHAPES.items():
            for dp in (1, 8, 64, 512):
                for budget in (5 << 30, 1 << 28):
                    got = TS.default_n_micro(cfg, shape, dp, budget)
                    b_local = max(1, shape.global_batch // dp)
                    need = math.ceil(b_local * cfg.n_layers * shape.seq_len
                                     * cfg.d_model * 2 / budget)
                    if shape.kind == "train" and need > b_local:
                        assert got == b_local, (name, key, dp, budget)
                        continue
                    assert got == JS.default_n_micro(
                        jax_get_config(name), JAX_SHAPES[key], dp, budget), \
                        (name, key, dp, budget)


def _same_specs(got: dict, want: dict, where):
    got, want = flatten_named(got), jax_flatten(want)
    assert list(got) == list(want), where
    for k in want:
        assert got[k].is_meta, (where, k)
        assert tuple(got[k].shape) == tuple(want[k].shape), (where, k)
        assert got[k].dtype == DTYPES[str(want[k].dtype)], (where, k)


@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_input_specs_match_the_reference(name):
    for key, shape in INPUT_SHAPES.items():
        _same_specs(TS.input_specs(get_config(name), shape),
                    JS.input_specs(jax_get_config(name), JAX_SHAPES[key]),
                    (name, key))


@pytest.mark.parametrize("name", SPEC_CONFIGS)
def test_cache_specs_match_the_reference_and_allocate_nothing(name):
    """Reduced configs (the reference's per-layer cache lists) at every
    input shape, the 524288-token decode included."""
    tcfg = get_config(name).reduced()
    jcfg = jax_get_config(name).reduced()
    model = Model(tcfg, device="cpu")
    jm = JaxModel(jcfg)
    for key, shape in INPUT_SHAPES.items():
        _same_specs(TS.cache_specs(model, shape),
                    JS.cache_specs(jm, JAX_SHAPES[key]), (name, key))
    live = model.init_cache(2, 8)
    assert all(t.device.type == "cpu" for t in flatten_named(live).values())


# ---------------------------------------------------------------------------
# resume and the CLI
# ---------------------------------------------------------------------------

def test_resume_is_bit_identical_at_the_step_level(tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    opt = AdamW(lr=warmup_cosine(3e-4, 1, 10))

    def run(p, s, steps, model):
        step = TS.make_train_step(model, opt, n_micro=2)
        for k in steps:
            p, s, _ = step(p, s, make_batch(cfg, 4, 16, seed=0, step=k,
                                            device="cpu"))
        return p, s

    def start():
        model = Model(cfg, seed=0, device="cpu")
        p = {k: v.detach().clone() for k, v in named_params(model).items()}
        return model, p, opt.init(p)

    model, p, s = start()
    whole = run(p, s, range(10), model)
    model, p, s = start()
    p, s = run(p, s, range(6), model)
    save_checkpoint(str(tmp_path), (p, s), step=6)
    model, p0, s0 = start()
    (p, s), at, _ = load_checkpoint(str(tmp_path), (p0, s0))
    assert at == 6 and isinstance(s["step"], int)
    resumed = run(p, s, range(6, 10), model)
    fa, fb = flatten_named(whole), flatten_named(resumed)
    assert list(fa) == list(fb)
    diff = [k for k in fa if not (torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]
    assert not diff, diff[:5]


CLI = ["--reduced", "--batch", "4", "--seq", "32", "--n-micro", "2",
       "--ttrace-every", "2", "--device", "cpu"]


def test_cli_trains_checks_saves_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    losses = train.main(CLI + ["--steps", "4", "--save", ck])
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert out.count("  [ttrace] regression check: PASS") == 1, out
    assert "arch=tinyllama-1.1b (reduced) params=" in out
    assert f"saved to {ck}" in out and "final loss" in out

    losses = train.main(CLI + ["--steps", "6", "--resume", ck,
                               "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"resumed from {ck} at step 4" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step ")] == ["4", "5"]
    assert len(losses) == 2 and "regression check: PASS" in out

    with pytest.raises(SystemExit, match="nothing to train.*step 4"):
        train.main(CLI + ["--steps", "4", "--resume", ck])

    # the reference reads the checkpoint under its own names and dtypes
    named, step, _ = jax_load_named(ck)
    assert step == 4
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    want = jax_flatten((params, JaxAdamW().init(params)))
    assert list(named) == list(want)
    for k, v in want.items():
        assert named[k].shape == v.shape and named[k].dtype == v.dtype, k


def test_cli_defaults_to_the_card():
    args = train.parse_args([])
    assert (args.device, args.arch, args.steps, args.batch, args.seq) == \
        ("cuda", "tinyllama-1.1b", 100, 8, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--reduced", "--steps", "1"])


def test_reduced_tinyllama_config_is_the_references():
    t = dataclasses.asdict(get_config("tinyllama-1.1b").reduced())
    j = dataclasses.asdict(jax_get_config("tinyllama-1.1b").reduced())
    assert {k: t[k] for k in t} == {k: j[k] for k in t}

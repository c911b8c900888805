"""The port's decode path (caches, ``Model.decode_step``, the decode
runner, the serving steps and CLI) against the JAX package's, on the CPU.

* ``decode_step`` over T steps from ``init_cache`` matches the reference's
  at f32, logits of every step and every leaf of the final caches (rtol
  1e-5, atol 1e-6 of the largest value), on reduced ``tinyllama-1.1b``
  (GQA), ``mixtral-8x7b`` at window 8 (the ring buffer wraps; MoE at B
  tokens), ``deepseek-v2-236b`` (MLA through both decode implementations,
  a dense layer 0, an MoE layer with a shared expert) and ``rwkv6-7b``
  (the state continuation).  The caches are the reference's leaves under
  its names, per layer.
* The decode path agrees with the training path: decode-stepped logits
  equal ``forward`` + ``unembed`` (the reference's ring-buffer test, atol
  2e-4), and ``make_prefill_step`` gives the last step's logits.
* MLA's cache is compressed (``tests/test_decode_ttrace.py``'s property).
* The inference check (``tests/test_decode_ttrace.py``) holds for the
  port: naive and absorbed MLA decode agree under floor-only thresholds,
  and ``decode_stale_rope_pos`` is flagged from a ``decode.t*`` record at
  t >= 1 with every logit finite; the reference's ``compare_traces``
  passes the port's decode trace against the JAX one (same records, same
  ``fwd_order``); ``ttrace_check(estimate=False)`` builds the reference's
  floor-only ``Thresholds``; ``decode_step`` on an arch without MLA
  refuses the MLA decode options.
* ``serve.generate`` at temperature 0 gives the greedy tokens of a loop
  over the reference's ``decode_step``; the CLI runs at ``--reduced
  --device cpu`` and refuses an encoder-only arch.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import configs, one_thread, to_jax_trace  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.core.harness import make_decode_runner as jax_decode_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, Thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint.store import flatten_named as torch_flatten  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.harness import make_decode_runner, ttrace_check  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.interop import params_from_jax, trace_to_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
B, T = 2, 12
MLA = "deepseek-v2-236b"
STALE = frozenset(["decode_stale_rope_pos"])


def setup_module():
    one_thread()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol * max(1.0, float(np.abs(want).max()))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@contextlib.contextmanager
def _mla_impl(impl, bugs=frozenset()):
    """The reference's trace-time switches of its MLA decode."""
    old = (jattn.MLA_DECODE_IMPL, jattn.MLA_DECODE_BUGS)
    jattn.MLA_DECODE_IMPL, jattn.MLA_DECODE_BUGS = impl, bugs
    try:
        yield
    finally:
        jattn.MLA_DECODE_IMPL, jattn.MLA_DECODE_BUGS = old


def _pair(jcfg, tcfg, seed=1):
    """(jax model, jax params, port model) on the same parameters."""
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    return jm, params, params_from_jax(named, Model(tcfg, device="cpu"))


def _case(case):
    """(jax cfg, port cfg, decode steps) of a parity case."""
    if case == "mixtral-swa8":
        jcfg, tcfg = (dataclasses.replace(c, window=8)
                      for c in configs("mixtral-8x7b"))
        return jcfg, tcfg, 24
    name = MLA if case.startswith(MLA) else case
    return (*configs(name), T)


@functools.lru_cache(maxsize=None)
def _jax_decode(case, impl="absorbed"):
    """The reference's logits of every step and final caches (numpy)."""
    jcfg, tcfg, steps = _case(case)
    jm, params, _ = _pair(jcfg, tcfg)
    toks = jnp.asarray(jax_make_batch(jcfg, B, steps)["tokens"])
    with _mla_impl(impl):
        dec = jax.jit(lambda p, c, x, t: jm.decode_step(p, c, x, t))
        cache = jm.init_cache(B, steps)
        outs = []
        for t in range(steps):
            lg, cache = dec(params, cache, toks[:, t:t + 1], jnp.int32(t))
            outs.append(np.asarray(lg))
    return (np.asarray(toks), outs,
            {k: np.asarray(v) for k, v in flatten_named(cache).items()})


@pytest.mark.parametrize("case,impl", [
    ("tinyllama-1.1b", "absorbed"), ("mixtral-swa8", "absorbed"),
    (MLA, "absorbed"), (MLA, "naive"), ("rwkv6-7b", "absorbed")])
def test_decode_matches_the_reference(case, impl):
    jcfg, tcfg, steps = _case(case)
    toks, jlogits, jcache = _jax_decode(case, impl)
    model = _pair(jcfg, tcfg)[2]
    cache = model.init_cache(B, steps)
    assert set(torch_flatten(cache)) == set(jcache)
    x = torch.tensor(toks)
    for t in range(steps):
        lg, cache = model.decode_step(cache, x[:, t:t + 1], t, mla_impl=impl)
        assert lg.shape == (B, 1, tcfg.vocab)
        _close(lg.numpy(), jlogits[t], f"logits t{t}")
    got = torch_flatten(cache)
    assert list(got) == list(jcache)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == jcache[name].shape, name
        _close(leaf.numpy(), jcache[name], f"cache {name}")
    if case == "mixtral-swa8":      # the ring holds the window, not T
        assert got["layers.0.k"].shape[1] == 8


def test_decode_equals_forward_through_the_ring():
    """The reference's ``test_swa_ring_buffer_matches_full_cache``: decode
    over 24 tokens through a ring of 8 slots gives ``forward``'s logits."""
    _, tcfg = configs("mixtral-8x7b")
    tcfg = dataclasses.replace(tcfg, window=8)
    model = Model(tcfg, seed=2, device="cpu")
    toks = make_batch(tcfg, 1, 24, seed=2, device="cpu")["tokens"]
    with torch.no_grad():
        want = model.unembed(model.forward({"tokens": toks}))
    cache = model.init_cache(1, 24)
    got = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0]
                     for t in range(24)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", MLA])
def test_prefill_step_gives_the_last_decode_logits(name):
    _, tcfg = configs(name)
    model = Model(tcfg, seed=3, device="cpu")
    toks = make_batch(tcfg, B, 16, seed=3, device="cpu")["tokens"]
    serve_step = make_serve_step(model)
    cache = model.init_cache(B, toks.shape[1])
    for t in range(toks.shape[1]):
        lg, cache = serve_step(cache, {"tokens": toks[:, t:t + 1], "pos": t})
    pre = make_prefill_step(model)({"tokens": toks})
    assert pre.shape == (B, 1, tcfg.vocab)
    _close(pre.numpy(), lg.numpy(), "prefill vs decode", rtol=1e-4,
           atol=1e-5)


def test_mla_cache_is_compressed():
    """The decode cache stores kv_lora + rope values a token, not per-head
    K (nope + rope) and V: 576 against 40960 at the published width."""
    cfg = get_config(MLA)
    m = Model(cfg.reduced(), device="cpu")
    cache = m.init_cache(2, 64)
    leaves = {x.shape[-1] for x in torch_flatten(cache).values()}
    rc = m.cfg.mla
    assert rc.kv_lora_rank in leaves and rc.qk_rope_dim in leaves
    full_dim = m.cfg.n_heads * (rc.qk_nope_dim + rc.v_head_dim)
    assert all(d < full_dim for d in leaves)
    full = cfg.mla
    assert full.kv_lora_rank + full.qk_rope_dim == 576
    assert cfg.n_heads * (full.qk_nope_dim + full.qk_rope_dim
                          + full.v_head_dim) == 40960


# ---------------------------------------------------------------------------
# the inference-mode check (tests/test_decode_ttrace.py, for the port)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ttrace_setup():
    """The reference test's setup: reduced deepseek-v2-236b with a dense
    MLP (no MoE), B 2 x 12 tokens."""
    jcfg, tcfg = (dataclasses.replace(c.reduced(), moe=None,
                                      arch_type="dense")
                  for c in (jax_get_config(MLA), get_config(MLA)))
    jm, params, model = _pair(jcfg, tcfg, seed=0)
    batch = {"tokens": np.asarray(jax_make_batch(jcfg, 2, 12)["tokens"])}
    return jm, params, model, batch


def _runner(model, impl, bugs=frozenset()):
    return make_decode_runner(model, functools.partial(
        model.decode_step, mla_impl=impl, mla_bugs=bugs), device="cpu")


def test_absorbed_vs_naive_mla_decode_equivalent():
    _, _, model, batch = _ttrace_setup()
    res = ttrace_check(_runner(model, "naive"), _runner(model, "absorbed"),
                       batch, estimate=False, localize=False, margin=64.0)
    assert res.passed, res.report.summary()
    # layer 0's latent cache is written by the same ``_ckv`` from the same
    # embeddings on both sides: bit-identical (deeper layers see the two
    # attentions' rounding)
    first = [n for n in res.reference.activations
             if n.startswith("decode.final_cache.layers.0.")]
    assert len(first) == 2
    for name in first:
        assert torch.equal(res.reference.activations.raw(name),
                           res.candidate.activations.raw(name)), name


def test_stale_rope_position_decode_bug_detected():
    _, _, model, batch = _ttrace_setup()
    res = ttrace_check(_runner(model, "naive"),
                       _runner(model, "absorbed", STALE), batch,
                       estimate=False, localize=False, margin=64.0)
    assert not res.passed
    assert all(np.isfinite(v).all()
               for v in res.candidate.activations.host().values())
    first = res.report.first_flagged_activation()
    # step 0 attends only to itself (the position clamps to 0)
    assert first.name.startswith("decode.t")
    assert not first.name.startswith("decode.t0/"), first.name


def test_decode_trace_passes_the_reference_checker():
    """The port's naive decode trace against the JAX naive one, under the
    reference's floor-only thresholds (f32, margin 64)."""
    jm, params, model, batch = _ttrace_setup()

    def jdec(p, c, x, t):
        with _mla_impl("naive"):
            return jm.decode_step(p, c, x, t)
    jtrace = jax_decode_runner(jm, params, decode_fn=jdec)(batch)
    port = _runner(model, "naive")(batch)
    assert port.meta["fwd_order"] == jtrace.meta["fwd_order"]
    assert "decode.final_cache.layers.1.ckv/value" in port.meta["fwd_order"]
    rep = jax_compare(jtrace, to_jax_trace(port),
                      Thresholds(eps=MACHINE_EPS["float32"], margin=64.0))
    assert rep.passed and not rep.missing, rep.summary()
    assert np.isclose(trace_to_numpy(port).loss, jtrace.loss, rtol=1e-5)


def test_floor_only_thresholds_are_the_reference():
    """``ttrace_check(estimate=False)`` on both packages: the same
    ``Thresholds`` fields and the same threshold for every record."""
    jm, params, model, batch = _ttrace_setup()
    short = {"tokens": batch["tokens"][:, :3]}

    def jdec(p, c, x, t):
        with _mla_impl("naive"):
            return jm.decode_step(p, c, x, t)
    jrun = jax_decode_runner(jm, params, decode_fn=jdec)
    eps = MACHINE_EPS["bfloat16"]
    jres = jax_check(jrun, jrun, short, eps=eps, margin=16.0,
                     estimate=False, localize=False)
    trun = _runner(model, "naive")
    tres = ttrace_check(trun, trun, short, eps=eps, margin=16.0,
                        estimate=False, localize=False)
    jt, tt = jres.thresholds, tres.thresholds
    assert (tt.eps, tt.margin, tt.floor_mult, tt.per_tensor) == (
        jt.eps, jt.margin, jt.floor_mult, jt.per_tensor)
    assert [(r.kind, r.name, r.threshold) for r in tres.report.records] == [
        (r.kind, r.name, r.threshold) for r in jres.report.records]
    assert "estimate" in tres.seconds and tres.passed and jres.passed


def test_decode_runner_refuses_rewrites():
    _, _, model, batch = _ttrace_setup()
    with pytest.raises(ValueError, match="no rewrites"):
        _runner(model, "naive")(batch, {"decode.t0/logits": 0.0})


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "rwkv6-7b"])
@pytest.mark.parametrize("impl,bugs", [("naive", frozenset()),
                                       ("absorbed", STALE)],
                         ids=["naive", "stale-rope"])
def test_non_mla_decode_refuses_mla_options(name, impl, bugs):
    """An MLA option on an arch without MLA would run clean unnoticed."""
    model = Model(configs(name)[1], device="cpu")
    cache = model.init_cache(B, 2)
    toks = torch.zeros(B, 1, dtype=torch.long)
    with pytest.raises(ValueError, match="need attn 'mla'"):
        model.decode_step(cache, toks, 0, mla_impl=impl, mla_bugs=bugs)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tinyllama-1.1b", MLA])
def test_generate_gives_the_reference_greedy_tokens(name):
    jcfg, tcfg = configs(name)
    jm, params, model = _pair(jcfg, tcfg, seed=4)
    P, gen = 8, 6
    prompt = jnp.asarray(jax_make_batch(jcfg, B, P, seed=4)["tokens"])
    dec = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, P + gen)
    for t in range(P):
        logits, cache = dec(params, cache, prompt[:, t:t + 1], jnp.int32(t))
    last = jnp.argmax(logits[:, 0], -1)[:, None]
    want = []
    for t in range(P, P + gen):
        logits, cache = dec(params, cache, last.astype(jnp.int32),
                            jnp.int32(t))
        want.append(np.asarray(last))
        last = jnp.argmax(logits[:, 0], -1)[:, None]
    got, t_prefill, t_dec = serve.generate(
        model, torch.tensor(np.asarray(prompt)), gen)
    assert got.tolist() == np.concatenate(want, axis=1).tolist()
    assert t_prefill > 0 and t_dec > 0


def test_generate_samples_from_its_generator():
    _, tcfg = configs("tinyllama-1.1b")
    model = Model(tcfg, seed=0, device="cpu")
    prompt = torch.zeros((2, 4), dtype=torch.long)
    runs = [serve.generate(model, prompt, 5, 1.0,
                           torch.Generator().manual_seed(s))[0]
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_decode_inputs_are_seeded_tokens():
    from repro_torch.data.synthetic import make_decode_inputs
    cfg = get_config("tinyllama-1.1b").reduced()
    a, b, c = (make_decode_inputs(cfg, 3, seed=s, step=1, device="cpu")
               for s in (5, 5, 6))
    assert a["tokens"].shape == (3, 1) and a["tokens"].dtype == torch.long
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < cfg.vocab


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--arch", MLA, "--reduced", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_serve_cli_refuses_an_encoder(monkeypatch):
    from repro_torch.configs import base
    enc = dataclasses.replace(get_config("tinyllama-1.1b"), causal=False)
    monkeypatch.setattr(base, "get_config", lambda name: enc)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--reduced", "--device", "cpu"])

"""The port's Mamba2 mixer and zamba2 hybrid (``models/ssm.Mamba2``,
``models/model.MambaBlock``, the shared attention block) against the JAX
package, on the CPU.  Inputs are made with numpy from a seed and handed to
both packages; on the CPU the port takes its plain versions.

* ``HybridConfig``, ``reduced()`` and the ``zamba2-7b`` config equal the
  reference's field for field.
* ``Mamba2`` against ``mamba2_forward``: y, the new conv and scan states
  and every gradient (parameters, x and the given state) within rtol 1e-5
  at f32, chunked, recurrent and continuing from ``state=``.
* Reduced ``zamba2-7b`` at ``ZAMBA_LAYERS`` layers (two uses of the shared
  block and a partial last group): ``named_parameters()`` is
  ``flatten_named``'s names in its order, the shared block's once; the
  AdamW decay mask is the reference's; the reference's ``compare_traces``
  passes the port's plain trace and its ``gla_scan`` candidate trace under
  the reference's f32 thresholds, the shared block's gradients summing its
  two uses; a doubled Mamba2 weight and a doubled shared-block weight get
  the reference harness's verdict and module.
* Decode: logits of every step and the final caches (each shared use its
  own) match the reference's ``decode_step``, and decode-stepped logits
  equal ``forward`` + ``unembed`` within the reference's own atol 2e-4.
* ``chip_smoke.gla_lin_attn``, the candidate's binding of
  ``models.ssm.lin_attn``: ``u=None`` goes to the kernel's inclusive
  (Mamba2) branch, ``u`` given to the exclusive (rwkv6) one; a state or
  the recurrent form raises, so a decode through it cannot drop a state.
"""
import copy
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (RWKV_SEQ, ZAMBA, ZAMBA_LAYERS,  # noqa: E402
                           configs, jax_setup, one_thread, to_jax_trace,
                           torch_model)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import flatten_named, unflatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.checkpoint.store import flatten_named as torch_flatten  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.collector import (SECTION_FIELDS, named_params,  # noqa: E402
                                        trace_train_step)
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

EPS = MACHINE_EPS["float32"]
RTOL, ATOL = 1e-5, 1e-6
# decode's logits and caches, against the largest value: at 5 layers the
# two packages' teacher-forced forward logits already differ by 1.8e-6 of
# 0.96 (f32 sums in another order, about 3e-7 a Mamba2 layer)
DECODE_ATOL = 1e-5
B, T = 2, 12


def setup_module():
    one_thread()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol * max(1.0, float(np.abs(want).max()))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _zamba():
    """(jax cfg, port cfg, jax model, jax params, named numpy params, numpy
    batch) of reduced zamba2-7b at B 2 x S 64 (two chunks of 32)."""
    jcfg, tcfg = configs(ZAMBA)
    _, jm, params, named, batch = jax_setup(ZAMBA, seq=RWKV_SEQ)
    return jcfg, tcfg, jm, params, named, batch


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_zamba2_config_equals_the_reference(reduced):
    j, t = jax_get_config(ZAMBA), get_config(ZAMBA)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t.hybrid) == dataclasses.asdict(j.hybrid)
    assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
    for f in dataclasses.fields(t):
        if f.name not in ("hybrid", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.hybrid.attn_every == (2 if reduced else 6)


# ---------------------------------------------------------------------------
# Mamba2 against mamba2_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["chunked", "recurrent", "continued"])
def test_mamba2_forward_state_and_gradients_match_the_reference(form):
    jcfg, tcfg = configs(ZAMBA)
    S = RWKV_SEQ
    p = JS.mamba2_init(jax.random.PRNGKey(4), jcfg, jnp.float32, 0.01)
    rng = np.random.default_rng(31)
    # A_log, D and dt_bias off their constant init, so each gradient counts
    p = dict(p, **{n: jnp.asarray(0.3 * rng.standard_normal(p[n].shape),
                                  jnp.float32)
                   for n in ("A_log", "D", "dt_bias")})
    named = {k: np.asarray(v) for k, v in flatten_named(p).items()}
    mod = params_from_jax(named, TS.Mamba2(torch.Generator().manual_seed(0),
                                           tcfg, torch.float32))
    assert [n for n, _ in mod.named_parameters()] == [
        "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm",
        "in_proj.w", "out_proj.w"]
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    st = None
    if form == "continued":
        d0 = JS.mamba2_init_state(jcfg, 2, jnp.float32)
        st = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in d0.items()}
    chunked = form != "recurrent"

    def jf(x, p, st):
        y, new = JS.mamba2_forward(p, jcfg, x, state=st, chunked=chunked)
        return jnp.sum(y * g) + jnp.sum(new["ssm"]) + jnp.sum(new["conv"]), \
            (y, new)
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    (_, (jy, jnew)), (jgx, jgp, jgs) = jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), p, jst)

    xt = torch.tensor(x, requires_grad=True)
    tst = (None if st is None else
           {k: torch.tensor(v, requires_grad=True) for k, v in st.items()})
    ty, tnew = mod(xt, state=tst, chunked=chunked)
    (torch.sum(ty * torch.tensor(g)) + torch.sum(tnew["ssm"])
     + torch.sum(tnew["conv"])).backward()
    _close(ty.detach().numpy(), jy, "y")
    for k in ("conv", "ssm"):
        assert tnew[k].dtype == torch.float32
        _close(tnew[k].detach().numpy(), jnew[k], f"state {k}")
    _close(xt.grad.numpy(), jgx, "dx")
    jgrads = flatten_named(jgp)
    for name, prm in mod.named_parameters():
        _close(prm.grad.numpy(), jgrads[name], name)
    if st is not None:
        for k in ("conv", "ssm"):
            _close(tst[k].grad.numpy(), jgs[k], f"d state {k}")


def test_mamba2_queries_and_keys_broadcast_over_heads(monkeypatch):
    """q and k reach the scan as the reference's ``broadcast_to``: views of
    C and B with head stride 0, not copies."""
    _, tcfg = configs(ZAMBA)
    mod = TS.Mamba2(torch.Generator().manual_seed(0), tcfg, torch.float32)
    seen, plain = [], TS.lin_attn

    def spy(q, k, v, log_w, chunk=128, u=None, s0=None, chunked=True):
        seen.append((q.stride(), k.stride(), log_w.shape, u, chunk))
        return plain(q, k, v, log_w, chunk=chunk, u=u, s0=s0,
                     chunked=chunked)
    monkeypatch.setattr(TS, "lin_attn", spy)
    mod(torch.zeros(1, 64, tcfg.d_model))
    (qs, ks, lw_shape, u, chunk), = seen
    assert qs[2] == 0 and ks[2] == 0 and qs[3] == ks[3] == 1
    H = tcfg.ssm.expand * tcfg.d_model // tcfg.ssm.d_head
    assert lw_shape == (1, 64, H, 1) and u is None and chunk == 32


# ---------------------------------------------------------------------------
# the hybrid model and the check
# ---------------------------------------------------------------------------

def test_names_order_and_decay_mask_are_the_reference_ones():
    _, _, _, params, named, _ = _zamba()
    model = torch_model(ZAMBA, named)
    assert list(named_params(model)) == list(named)
    assert len(named) == 3 + 9 * ZAMBA_LAYERS + 7 == 55
    assert "mamba0.0.mixer.in_proj.w" in named
    assert "shared_attn.mlp.down.w" in named
    assert not any(n.startswith(("shared_attn_", "shared_attn.0"))
                   for n in named)
    mask = dict(zip(named, jax.tree.leaves(JaxAdamW()._decay_mask(params))))
    assert {k: AdamW().decays(k) for k in named} == \
        {k: bool(v) for k, v in mask.items()}
    # a control's deepcopy keeps one shared block
    bad = copy.deepcopy(model)
    assert list(named_params(bad)) == list(named)
    assert [s for s, b in bad.scoped_blocks(bad.plan[1])] == ["shared_attn_0"]
    assert bad.scoped_blocks(bad.plan[1])[0][1] is \
        bad.scoped_blocks(bad.plan[3])[0][1] is bad.shared_attn


def _gla_calls(monkeypatch):
    """``ops.gla_scan`` counted (the plain version on the CPU)."""
    calls = []
    real = ops.gla_scan

    def counted(q, k, v, log_w, chunk=128, exclusive=False, u=None):
        calls.append((tuple(q.shape), exclusive, u is None))
        return real(q, k, v, log_w, chunk=chunk, exclusive=exclusive, u=u)
    monkeypatch.setattr(ops, "gla_scan", counted)
    return calls


def test_port_traces_pass_reference_checker(monkeypatch):
    jcfg, _, jm, params, named, batch = _zamba()
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch, EPS)
    model = torch_model(ZAMBA, named)
    plain, _, _ = trace_train_step(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        opt=AdamW(lr=1e-3))
    calls = _gla_calls(monkeypatch)
    cand = chip_smoke.gla_runner(model, AdamW(lr=1e-3))(batch)
    H = jcfg.ssm.expand * jcfg.d_model // jcfg.ssm.d_head
    assert calls == [((2, RWKV_SEQ, H, jcfg.ssm.d_state), False, True)] \
        * ZAMBA_LAYERS                       # one inclusive scan a layer
    assert TS.lin_attn.__name__ == "lin_attn"
    assert [n for n in jref.activations if n.startswith("shared_attn_")
            and n.endswith("/input")] == [
        "shared_attn_0.self_attention/input", "shared_attn_0.mlp/input",
        "shared_attn_1.self_attention/input", "shared_attn_1.mlp/input"]
    for tr in (plain, cand):
        port = to_jax_trace(tr)
        for sec in SECTION_FIELDS:
            assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
        assert port.meta["fwd_order"] == jref.meta["fwd_order"]
        rep = jax_compare(jref, port, thr)
        assert rep.passed and not rep.missing, rep.summary()
        assert port.loss == pytest.approx(jref.loss, rel=1e-5)


@pytest.mark.parametrize("bad_name,module", [
    ("mamba1.0.mixer.out_proj.w", "layers.2.mixer"),
    ("shared_attn.mlp.down.w", "shared_attn_0.mlp")])
def test_controls_match_reference_verdict(bad_name, module):
    _, _, jm, params, named, batch = _zamba()
    bad = dict(named)
    bad[bad_name] = named[bad_name] * np.float32(2.0)
    jbad = unflatten_named({k: jnp.asarray(v) for k, v in bad.items()},
                           params)
    jopt = JaxAdamW(lr=1e-3)
    jres = jax_check(jax_runner(jm, params, jopt, jopt.init(params)),
                     jax_runner(jm, jbad, jopt, jopt.init(jbad)), batch)
    opt = AdamW(lr=1e-3)
    tres = ttrace_check(
        make_model_runner(torch_model(ZAMBA, named), opt, device="cpu"),
        chip_smoke.gla_runner(torch_model(ZAMBA, bad), opt), batch)
    assert not tres.passed and not jres.passed
    assert tres.localized_module == jres.localized_module == module


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_decode():
    """The reference's tokens, logits of every step and final caches."""
    _, _, jm, params, _, batch = _zamba()
    toks = jnp.asarray(batch["tokens"][:, :T])
    dec = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, T)
    outs = []
    for t in range(T):
        lg, cache = dec(params, cache, toks[:, t:t + 1], jnp.int32(t))
        outs.append(np.asarray(lg))
    return (np.asarray(toks), outs,
            {k: np.asarray(v) for k, v in flatten_named(cache).items()})


def test_decode_matches_the_reference():
    toks, jlogits, jcache = _jax_decode()
    _, tcfg, _, _, named, _ = _zamba()
    model = torch_model(ZAMBA, named)
    cache = model.init_cache(B, T)
    assert list(cache) == [s.name for s in model.plan]
    assert set(torch_flatten(cache)) == set(jcache)
    assert {"shared_attn_0.0.k", "shared_attn_1.0.k", "mamba2.0.conv",
            "mamba0.1.ssm"} <= set(jcache)
    x = torch.tensor(toks)
    for t in range(T):
        lg, cache = model.decode_step(cache, x[:, t:t + 1], t)
        assert lg.shape == (B, 1, tcfg.vocab)
        _close(lg.numpy(), jlogits[t], f"logits t{t}", atol=DECODE_ATOL)
    got = torch_flatten(cache)
    assert list(got) == list(jcache)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == jcache[name].shape, name
        _close(leaf.numpy(), jcache[name], f"cache {name}", atol=DECODE_ATOL)


def test_decode_equals_forward():
    """The reference's ``test_decode_matches_forward`` for the port."""
    _, tcfg = configs(ZAMBA)
    model = Model(tcfg, seed=3, device="cpu")
    toks = make_batch(tcfg, 1, 16, seed=3, device="cpu")["tokens"]
    with torch.no_grad():
        want = model.unembed(model.forward({"tokens": toks}))
    cache, got = model.init_cache(1, 16), []
    for t in range(16):         # the SSM states are new each step
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        got.append(lg)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want.numpy(),
                               atol=2e-4)


# ---------------------------------------------------------------------------
# the candidate's binding
# ---------------------------------------------------------------------------

def test_gla_binding_routes_by_convention_and_refuses_a_state(monkeypatch):
    calls = _gla_calls(monkeypatch)
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((1, 64, 2, 8)),
                            dtype=torch.float32) for _ in range(3))
    lw1 = -torch.rand(1, 64, 2, 1)
    lw8 = -0.02 * torch.rand(1, 64, 2, 8)
    u = 0.3 * torch.ones(2, 8)
    for lw, uu in ((lw1, None), (lw8, u)):
        got = chip_smoke.gla_lin_attn(q, k, v, lw, chunk=32, u=uu)
        want = TS.lin_attn(q, k, v, lw, chunk=32, u=uu)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert calls == [((1, 64, 2, 8), False, True),
                     ((1, 64, 2, 8), True, False)]
    s0 = torch.zeros(1, 2, 8, 8)
    for kw in (dict(s0=s0), dict(chunked=False)):
        with pytest.raises(ValueError, match="zero state"):
            chip_smoke.gla_lin_attn(q, k, v, lw1, chunk=32, **kw)
    # a decode through the binding raises rather than drop the state
    _, tcfg = configs(ZAMBA)
    model = Model(tcfg, seed=0, device="cpu")
    cache = model.init_cache(1, 4)
    monkeypatch.setattr(TS, "lin_attn", chip_smoke.gla_lin_attn)
    with pytest.raises(ValueError, match="zero state"):
        model.decode_step(cache, torch.zeros(1, 1, dtype=torch.long), 0)
    assert len(calls) == 2

"""The port's RWKV-6 path (``models/ssm``, the ``rwkv`` blocks of
``models/model``, ``kernels/ssm_scan``, ``kernels/ops.gla_scan``) against
the JAX package on the CPU.  Inputs are made with numpy from a seed and
handed to both packages; on the CPU the port takes its plain versions.

* (a) ``lin_attn_recurrent`` and ``lin_attn_chunked`` against the
  reference's: scalar and per-channel decay, with and without ``u``, with
  ``s0``, and with S % chunk != 0 (the fallback); f32, rtol = atol = 1e-5;
* (b) ``gla_scan_ref`` against the reference's Pallas kernel in interpret
  mode and ``ops.gla_scan`` (with ``u``) against the reference's
  ``ops.gla_scan``, on the sweep of ``tests/test_kernels.py``; atol 5e-4,
  the reference tests' own;
* (c) the ``autograd.Function``: ``gradcheck`` in float64 (gradients of y
  and of the final state), and the same output and gradients as autograd
  of ``lin_attn_chunked`` with the bonus;
* (d) ``RWKV6TimeMix`` and ``RWKV6ChannelMix`` against ``rwkv6_time_mix``
  and ``rwkv6_channel_mix`` on reduced ``rwkv6-7b``; rtol = atol = 1e-5;
* (e) the whole reduced model, B 2 x S 64 (two chunks of 32): the
  reference's ``compare_traces``, under its own f32 thresholds, passes the
  port's plain trace and the port's candidate trace, whose scan a user
  routes to ``ops.gla_scan``;
* (f) with ``layers.1.time_mix.key.w`` doubled, the port's harness gives
  the reference harness's verdict and localized module.

* (g) the launch path without a card: one wrapper call is one launch of
  the three passes, with the scratch it allocates, and a failed launch
  raises with no second attempt;
* (h) the kernel's arithmetic, emulated: split TF32 operands in the
  chunk-parallel order meet ``chip_smoke.py`` phase 16's bounds on the
  sweep (f32) and on full-length rwkv6-like and zamba2-like heads (bf16),
  and one unsplit TF32 pass does not.

The CUDA kernel runs only on the card (``cuda`` marker).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (RWKV, RWKV_SEQ, configs, jax_setup,  # noqa: E402
                           one_thread, to_jax_trace, torch_model)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import unflatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.ssm_scan import gla_scan as jax_gla  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.model import build_plan as jax_build_plan  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs.base import get_config as torch_get_config  # noqa: E402
from repro_torch.core.collector import (SECTION_FIELDS, named_params,  # noqa: E402
                                        trace_fn_step, trace_train_step)
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as TK  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

EPS = MACHINE_EPS["float32"]
BAD = "layers.1.time_mix.key.w"


def setup_module():
    one_thread()


def _inputs(B, S, H, dk, dv, scalar, seed, strong=False):
    """q, k, v and log_w as numpy f32; decays drawn as test_kernels.py
    does (``strong``: per-channel decays of order 1, so the clamp acts)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    z = rng.standard_normal((B, S, H, 1 if scalar else dk))
    if scalar:
        lw = -np.logaddexp(0.0, z)                        # -softplus
    elif strong:
        lw = -np.logaddexp(0.0, z + 1.0)
    else:
        lw = -0.02 / (1.0 + np.exp(-z))                   # -0.02 sigmoid
    return q, k, v, lw.astype(np.float32)


def _t(arrs, grad=False, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------------------------
# (a) the scans against the reference's
# ---------------------------------------------------------------------------

SCAN_CASES = [
    # scalar, with u, with s0, S
    (True, False, False, 64), (False, False, False, 64),
    (False, True, False, 64), (False, True, True, 64),
    (True, False, True, 64), (False, True, False, 56),
    (True, False, True, 56),
]


@pytest.mark.parametrize("scalar,with_u,with_s0,S", SCAN_CASES)
def test_scans_match_reference(scalar, with_u, with_s0, S):
    B, H, dk, dv, chunk = 2, 2, 8, 16, 16
    arrs = _inputs(B, S, H, dk, dv, scalar, seed=S + 2 * scalar + with_u)
    rng = np.random.default_rng(7)
    u = (0.3 * rng.standard_normal((H, dk))).astype(np.float32)
    s0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    kw_j = dict(u=jnp.asarray(u) if with_u else None,
                s0=jnp.asarray(s0) if with_s0 else None)
    kw_t = dict(u=torch.from_numpy(u) if with_u else None,
                s0=torch.from_numpy(s0) if with_s0 else None)
    for jf, tf, kw in ((JS.lin_attn_recurrent, TS.lin_attn_recurrent, {}),
                       (JS.lin_attn_chunked, TS.lin_attn_chunked,
                        {"chunk": chunk})):
        jy, js = jf(*_j(arrs), **kw_j, **kw)
        ty, ts = tf(*_t(arrs), **kw_t, **kw)
        assert ty.dtype == torch.float32 and ty.shape == (B, S, H, dv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


def test_chunked_falls_back_to_recurrence(monkeypatch):
    seen = []
    fn = TS.lin_attn_recurrent
    monkeypatch.setattr(TS, "lin_attn_recurrent",
                        lambda *a, **k: seen.append(1) or fn(*a, **k))
    arrs = _t(_inputs(1, 40, 1, 4, 4, False, seed=3))
    TS.lin_attn_chunked(*arrs, chunk=16)
    TS.lin_attn_chunked(*arrs, chunk=8)
    assert seen == [1]


def test_prefix_sum_is_the_inclusive_cumsum():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 37, 5)))
    torch.testing.assert_close(TS.prefix_sum(x, 2), torch.cumsum(x, 2),
                               rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# (b) the plain kernel and ops.gla_scan against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dk,dv,chunk", [(16, 16, 32), (8, 32, 16),
                                         (32, 16, 64)])
@pytest.mark.parametrize("scalar,excl", [(True, False), (False, False),
                                         (False, True)])
def test_plain_gla_scan_matches_pallas_kernel(dk, dv, chunk, scalar, excl):
    B, S, H = 2, 128, 2
    arrs = _inputs(B, S, H, dk, dv, scalar, seed=dk + dv + chunk + excl)
    jy, js = jax_gla(*_j(arrs), chunk=chunk, exclusive=excl)
    TK.gla_scan.launches = 0
    ty, ts = TK.gla_scan(*_t(arrs), chunk=chunk, exclusive=excl)
    assert ty.dtype == ts.dtype == torch.float32
    assert ty.shape == (B, S, H, dv) and ts.shape == (B, H, dk, dv)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=5e-4)
    py, ps = TK.gla_scan_ref(*_t(arrs), chunk=chunk, exclusive=excl)
    assert torch.equal(py, ty) and torch.equal(ps, ts)
    # ops.gla_scan: the bonus on top, y in v's dtype
    u = (0.3 * np.random.default_rng(dk).standard_normal((H, dk))
         ).astype(np.float32)
    ju = jnp.asarray(u) if excl else None
    tu = torch.from_numpy(u) if excl else None
    jy2, js2 = jax_ops.gla_scan(*_j(arrs), chunk=chunk, exclusive=excl,
                                u=ju)
    ty2, ts2 = ops.gla_scan(*_t(arrs), chunk=chunk, exclusive=excl, u=tu)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), atol=5e-4)
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), atol=5e-4)
    assert TK.gla_scan.launches == 0              # CPU: no kernel launch


def test_strong_decay_clamp_matches_pallas_kernel():
    arrs = _inputs(1, 128, 2, 16, 16, False, seed=11, strong=True)
    assert float(np.cumsum(arrs[3][0, :64], axis=0).min()) < -TS.CLAMP
    for excl in (False, True):
        jy, js = jax_gla(*_j(arrs), chunk=64, exclusive=excl)
        ty, ts = TK.gla_scan(*_t(arrs), chunk=64, exclusive=excl)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=5e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=5e-4)


def test_shape_contract_is_the_reference_one():
    q, k, v, lw = _t(_inputs(1, 200, 2, 8, 8, False, seed=1))
    with pytest.raises(AssertionError):                 # the reference asserts
        jax_gla(*_j([t.numpy() for t in (q, k, v, lw)]), chunk=128)
    with pytest.raises(ValueError, match="multiple of chunk"):
        TK.gla_scan(q, k, v, lw)
    TK.gla_scan(q, k, v, lw, chunk=40)                  # 200 % 40 == 0
    TK.gla_scan(q[:, :64], k[:, :64], v[:, :64], lw[:, :64])   # chunk -> 64
    with pytest.raises(ValueError, match="log_w"):
        TK.gla_scan(q, k, v, lw[..., :3], chunk=40)
    with pytest.raises(ValueError, match="k must be"):
        TK.gla_scan(q, k[..., :4], v, lw, chunk=40)


def test_kernel_operand_checks():
    q, k, v, lw = _t(_inputs(1, 64, 2, 16, 16, False, seed=3))
    with pytest.raises(ValueError, match="CUDA device"):
        TK.check_kernel_operands(q, k, v, lw, 64)
    with pytest.raises(TypeError, match="float32"):
        TK.check_kernel_operands(q, k, v, lw.double(), 64)
    with pytest.raises(TypeError, match="share"):
        TK.check_kernel_operands(q, k.bfloat16(), v, lw, 64)
    strided = torch.zeros(1, 64, 2, 16, 2)[..., 0]
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        TK.check_kernel_operands(strided, k, v, lw, 64)
    wide = torch.zeros(1, 64, 2, 192)
    with pytest.raises(ValueError, match="up to 128"):
        TK.check_kernel_operands(wide, wide, v, wide, 64)
    # 16-byte staging: every row on a 16-byte boundary, whole 16-byte pieces
    bf = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    assert TK.staging_vec(bf, bf, bf, lw.new_zeros(2, 64, 4, 64))
    assert TK.staging_vec(bf, bf, bf, lw.new_zeros(2, 64, 4, 1))
    assert not TK.staging_vec(bf[..., 1:33], bf[..., :32], bf[..., :32],
                              lw.new_zeros(2, 64, 4, 32))
    assert not TK.staging_vec(bf, bf, bf[..., :60], lw.new_zeros(2, 64, 4, 64))


# ---------------------------------------------------------------------------
# (c) the autograd.Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scalar,excl", [(True, False), (False, False),
                                         (False, True)])
def test_function_gradcheck_float64(scalar, excl):
    arrs = _inputs(1, 8, 2, 3, 2, scalar, seed=13, strong=True)
    ins = _t(arrs, grad=True, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: TK._GLAScan.apply(*a, 4, excl), ins)
    # the gradient of y alone (an absent gradient of the final state)
    assert torch.autograd.gradcheck(
        lambda *a: TK._GLAScan.apply(*a, 4, excl)[0], ins)


def test_function_matches_autograd_of_lin_attn_chunked():
    B, S, H, dk, dv = 2, 64, 2, 8, 8
    arrs = _inputs(B, S, H, dk, dv, False, seed=17)
    u = (0.5 * np.ones((H, dk))).astype(np.float32)
    g = np.random.default_rng(18).standard_normal((B, S, H, dv)).astype(
        np.float32)
    got, want = _t([*arrs, u], grad=True), _t([*arrs, u], grad=True)
    y1, _ = ops.gla_scan(*got[:4], chunk=16, exclusive=True, u=got[4])
    y2, _ = TS.lin_attn_chunked(*want[:4], chunk=16, u=want[4])
    assert torch.equal(y1, y2)
    y1.backward(torch.from_numpy(g))
    y2.backward(torch.from_numpy(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (d)-(f) the modules, the model and the slice
# ---------------------------------------------------------------------------

def _rwkv():
    """(jax cfg, port cfg, jax model, jax params, named numpy params, numpy
    batch) of reduced rwkv6-7b at B 2 x S 64."""
    jcfg, tcfg = configs(RWKV)
    _, jm, params, named, batch = jax_setup(RWKV, seq=RWKV_SEQ)
    return jcfg, tcfg, jm, params, named, batch


def test_plan_names_and_decay_mask_are_the_reference_ones():
    jcfg, tcfg, jm, params, named, _ = _rwkv()
    assert tcfg.ssm == dataclasses.replace(
        tcfg.ssm, d_state=16, d_head=32, chunk=32, decay_lora=16, mix_lora=8)
    assert [(s.name, s.kind, s.n, s.layer0) for s in TM.build_plan(tcfg)] == \
        [("layers", "rwkv", 2, 0)]
    model = torch_model(RWKV, named)
    assert list(named_params(model)) == list(named)
    mask = dict(zip(named, jax.tree.leaves(JaxAdamW()._decay_mask(params))))
    assert {k: AdamW().decays(k) for k in named} == \
        {k: bool(v) for k, v in mask.items()}
    # the hybrid's plan is the reference's: groups of mamba layers, each
    # full one followed by a use of the shared block
    for reduced, layers in ((True, 5), (False, 12), (False, 81)):
        j, t = jax_get_config("zamba2-7b"), torch_get_config("zamba2-7b")
        if reduced:
            j, t = j.reduced(), t.reduced()
        j, t = (dataclasses.replace(c, n_layers=layers) for c in (j, t))
        assert [(s.name, s.kind, s.n, s.layer0, s.shared)
                for s in TM.build_plan(t)] == \
            [(s.name, s.kind, s.n, s.layer0, s.shared)
             for s in jax_build_plan(j)]


def test_time_mix_and_channel_mix_match_reference():
    jcfg, tcfg, _, params, named, _ = _rwkv()
    x = np.random.default_rng(21).standard_normal(
        (2, RWKV_SEQ, tcfg.d_model)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    for role, jf, cls in (("time_mix", JS.rwkv6_time_mix, TS.RWKV6TimeMix),
                          ("channel_mix", JS.rwkv6_channel_mix,
                           TS.RWKV6ChannelMix)):
        jout, _ = jf(params["layers"][1][role], jcfg, jnp.asarray(x))
        mod = cls(gen, tcfg, torch.float32)
        prefix = f"layers.1.{role}."
        with torch.no_grad():
            for name, p in mod.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(named[prefix + name])))
            tout, state = mod(torch.from_numpy(x))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(state["shift"], torch.from_numpy(x[:, -1:]))


def gla_candidate(model, opt, calls=None):
    """The gla_scan candidate as a user wires it: the reference model with
    ``models.ssm.lin_attn`` bound to ``ops.gla_scan`` for its forward."""
    params = named_params(model)

    def on_kernel(q, k, v, log_w, chunk=128, u=None, s0=None, chunked=True):
        assert s0 is None and chunked and u is not None
        if calls is not None:
            calls.append(tuple(q.shape))
        return ops.gla_scan(q, k, v, log_w, chunk=chunk, exclusive=True, u=u)

    def loss_call(b, ctx):
        plain = TS.lin_attn
        TS.lin_attn = on_kernel
        try:
            return model.loss(b, ctx=ctx)[0]
        finally:
            TS.lin_attn = plain

    def run(batch, rewrites=None):
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        return trace_fn_step(loss_call, params, b, opt=opt,
                             rewrites=rewrites)[0]
    return run


def test_port_traces_pass_reference_checker():
    _, _, jm, params, named, batch = _rwkv()
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch, EPS)
    model = torch_model(RWKV, named)
    plain, _, _ = trace_train_step(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        opt=AdamW(lr=1e-3))
    calls = []
    cand = gla_candidate(model, AdamW(lr=1e-3), calls)(batch)
    assert calls == [(2, RWKV_SEQ, 4, 32)] * 2        # one scan per layer
    assert TS.lin_attn is not None and TS.lin_attn.__name__ == "lin_attn"
    for tr in (plain, cand):
        port = to_jax_trace(tr)
        for sec in SECTION_FIELDS:
            assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
        assert port.meta["fwd_order"] == jref.meta["fwd_order"]
        rep = jax_compare(jref, port, thr)
        assert rep.passed and not rep.missing, rep.summary()
        assert port.loss == pytest.approx(jref.loss, rel=1e-5)


def test_doubled_key_weight_matches_reference_verdict():
    _, _, jm, params, named, batch = _rwkv()
    bad = dict(named)
    bad[BAD] = named[BAD] * np.float32(2.0)
    jbad = unflatten_named({k: jnp.asarray(v) for k, v in bad.items()},
                           params)
    jopt = JaxAdamW(lr=1e-3)
    jres = jax_check(jax_runner(jm, params, jopt, jopt.init(params)),
                     jax_runner(jm, jbad, jopt, jopt.init(jbad)), batch)
    opt = AdamW(lr=1e-3)
    tres = ttrace_check(
        make_model_runner(torch_model(RWKV, named), opt,
                          device="cpu"),
        gla_candidate(torch_model(RWKV, bad), opt), batch)
    assert not tres.passed and not jres.passed
    assert tres.localized_module == jres.localized_module == "layers.1.time_mix"


@pytest.mark.cuda
@pytest.mark.parametrize("scalar,excl", [(True, False), (False, True)])
def test_kernel_matches_plain_version_on_the_card(scalar, excl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    arrs = _inputs(2, 256, 4, 64, 64, scalar, seed=5)
    q, k, v, lw = (t.cuda() for t in _t(arrs))
    before = TK.gla_scan.launches
    y1, s1 = TK.gla_scan(q, k, v, lw, exclusive=excl)
    y2, s2 = TK.gla_scan(q, k, v, lw, exclusive=excl)
    assert TK.gla_scan.launches == before + 2
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    py, ps = TK.gla_scan_ref(q, k, v, lw, exclusive=excl)
    torch.testing.assert_close(y1, py, rtol=0, atol=5e-4)
    torch.testing.assert_close(s1, ps, rtol=0, atol=5e-4)


# ---------------------------------------------------------------------------
# (g) the launch path without a card
# ---------------------------------------------------------------------------

def test_scratch_and_profile_layout():
    kv, decay = TK.scratch_shapes(2, 4096, 64, 64, 60, 64, 128)
    assert kv == (32, 2, 64, 64, 60) and decay == (32, 2, 64, 64)
    assert TK.scratch_shapes(1, 256, 2, 8, 30, 1, 64) == ((4, 1, 2, 8, 32),
                                                         (4, 1, 2, 1))
    assert TK.profile_blocks(2, 4096, 112, 64, 64, 128) == {
        "state": 7168, "fold": 3584, "out": 7168}
    # a state block per 64 channels of dk
    assert TK.profile_blocks(1, 256, 2, 100, 72, 128)["state"] == 2 * 2 * 2
    assert set(TK.PHASES) == set(TK.PASSES)
    assert all(len(ph) <= TK.PROFILE_SLOTS for ph in TK.PHASES.values())


def test_kernel_launch_never_falls_back(monkeypatch):
    calls, rc = [], [0]

    def fake_lib(*_):
        def fn(*args):
            calls.append(args)
            return rc[0]
        return fn
    monkeypatch.setattr(TK, "_lib", fake_lib)
    q, k, v, lw = _t(_inputs(1, 64, 2, 16, 8, False, seed=19))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    outs = TK._outputs(q, v, lw, 32)
    assert [tuple(t.shape) for t in outs] == [
        (1, 64, 2, 8), (1, 2, 16, 8), (2, 1, 2, 16, 8), (2, 1, 2, 16)]
    before = TK.gla_scan.launches
    TK._run(q, k, v, lw, 32, True, *outs, stream=0)
    assert calls == [(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      lw.data_ptr(), *(t.data_ptr() for t in outs),
                      1, 64, 2, 16, 8, 16, 32, 0b111, *q.stride()[:3],
                      *k.stride()[:3], *v.stride()[:3], *lw.stride()[:3], 0)]
    assert TK.gla_scan.launches == before + 1
    rc[0] = 719                                   # a failed launch
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        TK._run(q, k, v, lw, 32, False, *outs, stream=0)
    assert len(calls) == 2                        # no second attempt
    assert calls[-1][15] == 0b110                 # inclusive
    assert TK.gla_scan.launches == before + 1


# ---------------------------------------------------------------------------
# (h) the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

SWEEP_TOL = 5e-4        # chip_smoke.py SSM_SWEEP_TOL: absolute, f32 sweep
NORM_TOL = 1e-5         # chip_smoke.py SSM_NORM_TOL: normwise, bf16 shapes


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 fraction bits, ties away."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7fffffff) + 0x1000) & ~0x1fff
    return (mag | (b & -2 ** 31)).view(torch.float32)


def _read(x):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1fff).view(torch.float32)


def _mma(acc, a, b, a_split, b_split, split=True):
    """acc (f32) += a @ b as the kernel's TF32 wgmmas: an operand that is
    not exact is split, x = hi + lo with hi = tf32(x); per k8 step the
    products hi.hi, hi.lo and lo.hi, each step's 8 exact products summed
    and rounded to f32, join the f32 accumulator in turn.  ``split=False``:
    one TF32 pass, each operand rounded once."""
    def parts(x, s):
        if not split:
            return [_tf32(x)]
        if not s:
            return [x]
        hi = _tf32(x)
        return [hi, _read(x - hi)]
    A, B = parts(a, a_split), parts(b, b_split)
    pairs = [(A[0], B[0])] + [(A[0], lo) for lo in B[1:]] + \
        [(lo, B[0]) for lo in A[1:]]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            acc = acc + (x[..., k0:k0 + 8].double()
                         @ y[..., k0:k0 + 8, :].double()).float()
    return acc


def _emulate_kernel(q, k, v, lw, chunk, exclusive, split=True):
    """``csrc/ssm_scan.cu``'s arithmetic on the CPU: L scanned in float64
    (scalar decay; the exponents' differences too) or f32 (per-channel),
    each exponent rounded to f32 for its exponential; the state pass's
    k_dec^T v, the f32 fold, then the out pass's
    A = q_t k_t^T (or (q k^T) D), y = q_t S + A v, all products as
    ``_mma``.  q and k in the scalar branch and v are exact in TF32 when
    bf16, and then not split."""
    B, S, H, dk = q.shape
    dv, C = v.shape[3], chunk
    n = S // C
    scalar = lw.shape[3] == 1
    qk_split = not (scalar and q.dtype == torch.bfloat16)
    v_split = v.dtype != torch.bfloat16

    def split_chunks(x):                      # (B,S,H,d) -> (B,H,n,C,d)
        return x.float().reshape(B, n, C, H, -1).permute(0, 3, 1, 2, 4)
    qc, kc, vc, wc = map(split_chunks, (q, k, v, lw))
    # the kernel scans a scalar decay in float64, a per-channel one in f32
    L = torch.cumsum(wc.double() if scalar else wc, dim=3)
    Lq = L - wc if exclusive else L
    Lc = L[..., -1:, :]

    def exp(x):                                    # the exponent in f32
        return torch.exp(x.float())
    kv = _mma(torch.zeros(B, H, n, dk, dv),
              (kc * exp(Lc - L)).transpose(-1, -2), vc, True, v_split,
              split)
    decay = exp(Lc[..., 0, :])[..., None]
    s = torch.zeros(B, H, dk, dv)
    starts = []
    for c in range(n):
        starts.append(s)
        s = decay[:, :, c] * s + kv[:, :, c]
    s0 = torch.stack(starts, dim=2)
    causal = torch.tril(torch.ones(C, C, dtype=torch.bool),
                        -1 if exclusive else 0)
    zero = torch.zeros(B, H, n, C, C)
    if scalar:
        D = exp(torch.clamp(Lq[..., 0][..., :, None]
                            - L[..., 0][..., None, :], max=0.0))
        A = _mma(zero, qc, kc.transpose(-1, -2), qk_split, qk_split, split)
        A = torch.where(causal, A * D, 0.0)
        y = _mma(torch.zeros(B, H, n, C, dv), qc, s0, qk_split, True,
                 split) * exp(Lq)
    else:
        qt = qc * exp(Lq)
        kt = kc * exp(-torch.clamp(L, min=-TS.CLAMP))
        A = torch.where(causal, _mma(zero, qt, kt.transpose(-1, -2), True,
                                     True, split), 0.0)
        y = _mma(torch.zeros(B, H, n, C, dv), qt, s0, True, True, split)
    y = _mma(y, A, vc, True, v_split, split)
    return y.permute(0, 2, 3, 1, 4).reshape(B, S, H, dv), s


def _head(kind, seed):
    """One full-length head (S 4096, chunk 128, d 64) as ``chip_smoke.py``
    phase 16 draws it: rwkv6-like, per-channel exclusive with decays
    -exp(-6 + a small LoRA term), or zamba2-like, scalar inclusive with
    -softplus decays; q, k and v N(0, 1) in bf16."""
    rng = np.random.default_rng(seed)
    S, d = 4096, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, 1, d))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    if kind == "rwkv6":
        lw = -np.exp(-6.0 + 0.12 * rng.standard_normal((1, S, 1, d)))
    else:
        lw = -np.logaddexp(0.0, rng.standard_normal((1, S, 1, 1)))
    return q, k, v, torch.from_numpy(lw.astype(np.float32))


def _normwise(got, ref):
    return float((got.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("dk,dv,chunk", [(16, 16, 32), (8, 32, 16),
                                         (32, 16, 64)])
@pytest.mark.parametrize("scalar,excl", [(True, False), (False, False),
                                         (False, True)])
def test_emulated_kernel_meets_the_sweep_bound(dk, dv, chunk, scalar, excl):
    arrs = _t(_inputs(2, 128, 2, dk, dv, scalar, seed=dk + dv + chunk + excl))
    y, s = _emulate_kernel(*arrs, chunk, excl)
    y64, s64 = TK.gla_scan_ref(*(t.double() for t in arrs), chunk=chunk,
                               exclusive=excl)
    assert y.dtype == s.dtype == torch.float32
    err = max(float((y.double() - y64).abs().max()),
              float((s.double() - s64).abs().max()))
    assert err <= SWEEP_TOL


@pytest.mark.parametrize("kind,excl", [("rwkv6", True), ("zamba2", False)])
def test_split_tf32_meets_the_card_bound_and_one_tf32_pass_does_not(kind,
                                                                    excl):
    q, k, v, lw = _head(kind, seed=23)
    y64, s64 = TK.gla_scan_ref(q.double(), k.double(), v.double(),
                               lw.double(), chunk=128, exclusive=excl)
    y, s = _emulate_kernel(q, k, v, lw, 128, excl)
    assert max(_normwise(y, y64), _normwise(s, s64)) <= NORM_TOL
    if kind == "rwkv6":
        y1, s1 = _emulate_kernel(q, k, v, lw, 128, excl, split=False)
        assert max(_normwise(y1, y64), _normwise(s1, s64)) > NORM_TOL


def test_tf32_rounding_model():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11),
                      3.0, 2.0 ** -130])
    hi = _tf32(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9), 3.0,
                           _read(x)[4].item()]
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert float((_read(lo) - lo).abs().max()) <= 2.0 ** -21

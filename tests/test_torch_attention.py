"""The port's flash-attention path (``kernels/flash_attention``,
``models/attention``, ``models/layers.chunked_cross_entropy``) against the
JAX package on the CPU.

* (a) ``ops.flash_attention`` on CPU tensors (its plain version) against
  the reference's Pallas kernel in interpret mode, ``bq = bk = 64``, on
  the sweep of ``tests/test_kernels.py``: f32 within atol 2e-5 (f32
  summation order), bf16 within atol 2e-2 (one bf16 rounding of outputs
  of order 1, as ``test_kernels.py``);
* (b) the ``autograd.Function``: output and gradients identical to
  ``attention_ref``'s on the CPU; ``gradcheck`` in float64;
* (c) ``attention_blockwise`` against the reference's and against the
  port's ``attention_ref``, f32 within 2e-5;
* (d) ``chunked_cross_entropy``: value and gradients against the
  reference's, rtol 1e-5 (f32 sums over chunks in another order);
* (e) ``Model.forward(use_kernel=True)`` against the reference's (the
  Pallas kernel in interpret mode) on reduced ``gpt-paper`` and on reduced
  ``tinyllama-1.1b`` with 2 kv heads, rtol 1e-5 / atol 1e-5;
* (f) the flash candidate, ``trace_fn_step`` over ``loss(use_kernel=True)``
  as a user builds it, passes the reference's ``compare_traces`` against
  the reference's own (``use_kernel=False``) trace and thresholds: the
  reference cannot differentiate its own kernel (``jax.grad`` through the
  Pallas call raises), so its plain trace is the one to meet;
* (g) the long path, S 4096 with S x vocab > 2^26: blockwise attention and
  chunked CE on both sides, the port's reference trace and its flash
  candidate's trace judged by the reference's checker;
* (h) the launch path without a card: bf16 goes to the TMA + wgmma entry
  point and f32 to the FMA one (``_lib`` replaced by a fake), a failed
  launch raises with no second call, bf16 operands must meet TMA's 16-byte
  rules, and a library's name hashes the headers it can include;
* (i) why the bf16 kernel splits p: a CPU emulation of its arithmetic
  (bf16 q, k, v; f32 scores and online softmax over kv tiles of 64; p v as
  p_hi v + p_lo v, both bf16, summed in f32) stays within the card check's
  bound, half a bf16 ulp of float64 plus 2e-5, on the sweep of
  ``tests/test_kernels.py`` in every mode, and the same emulation with one
  bf16 p exceeds it.

The CUDA kernels run only on the card (``cuda`` marker).
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_thread, to_jax_trace  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs.base import get_config as torch_get_config  # noqa: E402
from repro_torch.core.collector import (SECTION_FIELDS, named_params,  # noqa: E402
                                        trace_fn_step, trace_train_step)
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

MODES = [("causal", 0), ("swa", 64), ("bidirectional", 0)]
EPS = MACHINE_EPS["float32"]


def setup_module():
    one_thread()


def _qkv(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def _t(arrs, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrs]


# ---------------------------------------------------------------------------
# (a) the plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 2, 128),
    (1, 128, 4, 1, 64),
])
@pytest.mark.parametrize("mode,window", MODES)
def test_plain_flash_matches_pallas_kernel(B, S, H, Hkv, D, mode, window):
    arrs = _qkv(B, S, H, Hkv, D, seed=B * S + H + D)
    want = np.asarray(jax_flash(*map(jnp.asarray, arrs), mode=mode,
                                window=window, bq=64, bk=64))
    TF.flash_attention.launches = 0
    got = ops.flash_attention(*_t(arrs), mode=mode, window=window, bq=64,
                              bk=64)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert TF.flash_attention.launches == 0          # CPU: no kernel launch


def test_plain_flash_bf16_matches_pallas_kernel():
    arrs = _qkv(1, 128, 4, 2, 64, seed=5)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    want = np.asarray(jax_flash(*jb, bq=64, bk=64), np.float32)
    got = ops.flash_attention(*_t(arrs, torch.bfloat16), bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


def test_shape_contract_is_the_reference_one():
    q, k, v = _t(_qkv(1, 768, 2, 2, 64, seed=1))
    with pytest.raises(AssertionError):                 # the reference asserts
        jax_flash(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())))
    with pytest.raises(ValueError, match="multiple of bq"):
        ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v, bq=256, bk=256)       # 768 % 256 == 0
    q4, k4, v4 = _t(_qkv(1, 64, 6, 4, 64, seed=2))
    with pytest.raises(ValueError, match="Hkv"):
        ops.flash_attention(q4, k4, v4)
    with pytest.raises(TypeError, match="share"):
        ops.flash_attention(q[:, :64], k[:, :64].bfloat16(), v[:, :64])
    with pytest.raises(ValueError, match="unknown attention mode"):
        ops.flash_attention(q, k, v, mode="full", bq=256, bk=256)


def test_kernel_operand_checks():
    q, k, v = _t(_qkv(1, 64, 2, 2, 64, seed=3))
    with pytest.raises(ValueError, match="CUDA device"):
        TF.check_kernel_operands(q, k, v)
    q32 = _t(_qkv(1, 64, 2, 2, 32, seed=3))[0]
    with pytest.raises(ValueError, match="D in"):
        TF.check_kernel_operands(q32, q32, q32)
    strided = torch.zeros(1, 64, 2, 64, 2)[..., 0]     # head-dim stride 2
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        TF.check_kernel_operands(strided, k, v)
    rows = torch.zeros(1, 64, 2, 66)[..., 1:65]        # rows off by 1 element
    with pytest.raises(ValueError, match="4-element"):
        TF.check_kernel_operands(q, rows, v)


# ---------------------------------------------------------------------------
# (b) the autograd.Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,window", MODES)
def test_function_matches_attention_ref_and_its_gradients(mode, window):
    arrs = _qkv(2, 128, 4, 2, 64, seed=11)
    g = np.random.default_rng(12).standard_normal((2, 128, 4, 64)).astype(
        np.float32)
    got, want = _t(arrs, grad=True), _t(arrs, grad=True)
    o1 = ops.flash_attention(*got, mode=mode, window=window)
    o2 = TA.attention_ref(*want, mode=mode, window=window)
    assert torch.equal(o1, o2)
    o1.backward(torch.from_numpy(g))
    o2.backward(torch.from_numpy(g))
    for a, b in zip(got, want):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("mode,window", [("causal", 0), ("swa", 3),
                                         ("bidirectional", 0)])
def test_function_gradcheck_float64(mode, window):
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 8, 2, 4), (1, 8, 1, 4), (1, 8, 1, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: TF._FlashAttention.apply(q, k, v, mode, window),
        (q, k, v))


# ---------------------------------------------------------------------------
# (c) attention_blockwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,window", [("causal", 0), ("swa", 300),
                                         ("bidirectional", 0)])
def test_blockwise_matches_reference(mode, window):
    arrs = _qkv(1, 1024, 4, 2, 32, seed=21)
    want = np.asarray(JA.attention_blockwise(
        *map(jnp.asarray, arrs), mode=mode, window=window, q_block=256,
        kv_block=256))
    q, k, v = _t(arrs)
    got = TA.attention_blockwise(q, k, v, mode=mode, window=window,
                                 q_block=256, kv_block=256)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    ref = TA.attention_ref(q, k, v, mode=mode, window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)


def test_attention_routes_as_the_reference(monkeypatch):
    seen = []
    for name in ("attention_ref", "attention_blockwise"):
        fn = getattr(TA, name)
        monkeypatch.setattr(TA, name, lambda *a, _f=fn, _n=name, **kw:
                            seen.append(_n) or _f(*a, **kw))
    for S in (2048, 2560):
        q, k, v = _t(_qkv(1, S, 1, 1, 16, seed=S))
        TA.attention(q, k, v)
    assert seen == ["attention_ref", "attention_blockwise"]


# ---------------------------------------------------------------------------
# (d) chunked_cross_entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk,masked", [(256, 64, False), (256, 64, True),
                                            (160, 64, False)],
                         ids=["chunked", "masked", "fallback"])
def test_chunked_ce_matches_reference(S, chunk, masked):
    rng = np.random.default_rng(S + masked)
    B, D, V = 2, 32, 96
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    e = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7) if masked else None

    def jf(h, e):
        return JL.chunked_cross_entropy(
            h, e, jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), chunk=chunk)
    jv, (jgh, jge) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(e))
    th, te = _t([h, e], grad=True)
    tv = TL.chunked_cross_entropy(
        th, te, torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask), chunk=chunk)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jge), rtol=1e-5,
                               atol=1e-8)
    plain = TL.cross_entropy(TL._logits(th.detach(), te.detach()),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(tv.detach()), float(plain), rtol=1e-5)


# ---------------------------------------------------------------------------
# (e)-(g) the model and the slice
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup(name, batch, seq, **kw):
    """(jax model, jax params, port model, numpy batch) for a reduced config
    with ``kw`` replaced; the port model carries the reference's params
    (a run never changes them, so the tests share it)."""
    kw = dict(dict(n_layers=2, vocab=256), **kw)
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **kw)
    tcfg = dataclasses.replace(torch_get_config(name).reduced(), **kw)
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    tm = params_from_jax(named, TM.Model(tcfg, device="cpu"))
    b = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, batch, seq).items()}
    return jm, params, tm, b


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def flash_candidate(model, opt):
    """The flash-attention candidate as a user wires it: the generic
    collector over ``loss(use_kernel=True)``."""
    params = named_params(model)

    def loss_call(b, ctx):
        return model.loss(b, ctx=ctx, use_kernel=True)[0]

    def run(batch, rewrites=None):
        return trace_fn_step(loss_call, params, _tb(batch), opt=opt,
                             rewrites=rewrites)[0]
    return run


CASES = [("gpt-paper", {}), ("tinyllama-1.1b", {"n_kv_heads": 2})]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_forward_with_kernel_matches_reference(name, kw):
    jm, params, tm, batch = _setup(name, 2, 128, **kw)
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == (2 if kw else 1)
    jh, _ = jm.forward(params, {k: jnp.asarray(v) for k, v in batch.items()},
                       use_kernel=True)
    with torch.no_grad():
        th = tm.forward(_tb(batch), use_kernel=True)
        plain = tm.forward(_tb(batch))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(th, plain)          # CPU: the kernel's plain version


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_flash_candidate_passes_reference_checker(name, kw):
    jm, params, tm, batch = _setup(name, 2, 128, **kw)
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch, EPS)
    port = to_jax_trace(flash_candidate(tm, AdamW(lr=1e-3))(batch))
    for sec in SECTION_FIELDS:
        assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
    rep = jax_compare(jref, port, thr)
    assert rep.passed and not rep.missing, rep.summary()
    assert port.loss == pytest.approx(jref.loss, rel=1e-5)


def test_long_path_passes_reference_checker(monkeypatch):
    S, V = 4096, 16512
    assert S * V > TM._CHUNKED_CE_ELEMS and S % 1024 == 0
    jm, params, tm, batch = _setup("gpt-paper", 1, S, n_layers=1, vocab=V)
    calls = []
    for mod, name in ((TA, "attention_blockwise"),
                      (TM, "chunked_cross_entropy")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch, EPS)
    ref_tr, _, _ = trace_train_step(tm, _tb(batch), opt=AdamW(lr=1e-3))
    # reference: blockwise forward, chunked CE
    assert calls == ["attention_blockwise", "chunked_cross_entropy"]
    calls.clear()
    cand_tr = flash_candidate(tm, AdamW(lr=1e-3))(batch)
    # candidate: the kernel's forward, chunked CE, then the backward's
    # blockwise recompute
    assert calls == ["chunked_cross_entropy", "attention_blockwise"]
    for tr in (ref_tr, cand_tr):
        port = to_jax_trace(tr)
        rep = jax_compare(jref, port, thr)
        assert rep.passed and not rep.missing, rep.summary()
        assert port.loss == pytest.approx(jref.loss, rel=1e-5)


# ---------------------------------------------------------------------------
# (h) the launch path without a card
# ---------------------------------------------------------------------------

def test_kernel_routes_by_dtype_and_never_falls_back(monkeypatch):
    calls, rc = [], [0]

    def fake_lib(source, symbol):
        def fn(*args):
            calls.append((source, symbol, args))
            return rc[0]
        return fn
    monkeypatch.setattr(TF, "_lib", fake_lib)
    before = TF.flash_attention.launches
    for dtype, symbol in ((torch.bfloat16, "repro_flash_attention_wgmma"),
                          (torch.float32, "repro_flash_attention_fma")):
        q, k, v = _t(_qkv(2, 64, 4, 2, 64, seed=7), dtype)
        out = torch.empty_like(q)
        TF._run(q, k, v, out, "swa", 16, stream=0)
        source, got, args = calls[-1]
        assert (source, got) == TF.ENTRY_POINTS[dtype]
        assert got == symbol
        assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr())
        assert args[4:9] == (2, 64, 4, 2, 64)
        assert args[9:18] == (*q.stride()[:3], *k.stride()[:3],
                              *v.stride()[:3])
        assert args[18:] == (1, 16, pytest.approx(0.125), 0)
    assert len(calls) == 2
    assert TF.flash_attention.launches == before + 2
    rc[0] = 719                                   # a failed launch
    q, k, v = _t(_qkv(1, 64, 2, 2, 64, seed=8), torch.bfloat16)
    with pytest.raises(RuntimeError, match="wgmma failed: CUDA error 719"):
        TF._run(q, k, v, torch.empty_like(q), "causal", 0, stream=0)
    assert len(calls) == 3                        # no second attempt
    assert TF.flash_attention.launches == before + 2


def test_bf16_operands_meet_tma_rules():
    q, k, v = _t(_qkv(1, 64, 2, 2, 64, seed=9), torch.bfloat16)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[4:4 + q.numel()].view(q.shape)  # 8 bytes past 16
    assert shifted.data_ptr() % 16 == 8 and shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned base"):
        TF.check_kernel_operands(shifted, k, v)
    rows = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)[..., :64]
    assert rows.stride()[2] % 4 == 0              # the f32 rule holds
    with pytest.raises(ValueError, match="8-element"):
        TF.check_kernel_operands(q, rows, v)
    # what passes TMA's rules goes on to the device check
    with pytest.raises(ValueError, match="CUDA device"):
        TF.check_kernel_operands(q, k, v)


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.lib_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.lib_path("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = build.lib_path("k")
    assert len({first, second, third}) == 3
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")


# ---------------------------------------------------------------------------
# (i) the bf16 kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def _emulate_bf16_kernel(q, k, v, mode, window, split, tile=64):
    """The bf16 kernel's arithmetic in f32 on the CPU: scores of bf16 q, k
    in f32, an online softmax over kv tiles of ``tile`` with masked p set
    to 0, p v from bf16 p (``split``: p_hi + p_lo) summed in f32, out =
    acc / max(l, 1e-30) rounded to bf16."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)
    kh = k.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    vh = v.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kp = torch.arange(k0, k0 + tile)[None, :]
        keep = torch.ones(S, tile, dtype=torch.bool)
        if mode != "bidirectional":
            keep = kp <= qp
        if mode == "swa":
            keep = keep & (kp > qp - window)
        s = (qh @ kh[:, :, k0:k0 + tile].transpose(-1, -2)) / math.sqrt(D)
        s = torch.where(keep, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        vt = vh[:, :, k0:k0 + tile]
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16().permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 2, 2, 64), (2, 256, 4, 2, 64), (1, 256, 8, 2, 128),
    (1, 128, 4, 1, 64),
])
@pytest.mark.parametrize("mode,window", MODES)
def test_split_p_meets_the_card_bound_and_one_bf16_p_does_not(
        B, S, H, Hkv, D, mode, window):
    q, k, v = _t(_qkv(B, S, H, Hkv, D, seed=B * S + H + D), torch.bfloat16)
    ref = TA.attention_ref(q.double(), k.double(), v.double(), mode=mode,
                           window=window)
    bound = 2.0 ** -8 * ref.abs() + 2e-5          # chip_smoke.py, phase 11
    split = _emulate_bf16_kernel(q, k, v, mode, window, split=True)
    single = _emulate_bf16_kernel(q, k, v, mode, window, split=False)
    assert split.dtype == torch.bfloat16 and split.shape == q.shape
    assert bool(((split.double() - ref).abs() <= bound).all())
    over = (single.double() - ref).abs() > bound
    assert int(over.sum()) > over.numel() // 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (t.cuda() for t in _t(_qkv(2, 256, 8, 2, 64, seed=4), dt))
    before = TF.flash_attention.launches
    k1 = ops.flash_attention(q, k, v, mode="swa", window=64)
    k2 = ops.flash_attention(q, k, v, mode="swa", window=64)
    assert TF.flash_attention.launches == before + 2
    assert torch.equal(k1, k2)
    p = TF.flash_attention_ref(q, k, v, mode="swa", window=64)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(k1.float(), p.float(), rtol=0, atol=tol)

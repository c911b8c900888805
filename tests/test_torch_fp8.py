"""The port's FP8 recipes (``precision/fp8``, ``kernels/fp8_matmul``)
against the JAX package on the CPU.

* quantization: ``quantize_e4m3`` gives the reference's bytes and scales;
* kernels: the plain versions against the reference's Pallas kernels in
  interpret mode (global: atol 1e-2 on 8 * N(0,1) operands, as
  ``test_kernels.py``; tile128: rtol 1e-5, atol 1e-4, as
  ``test_pp_fp8.py``);
* ``fp8_linear``: forward and straight-through gradients in f32, rtol 1e-5
  with an atol of 1e-6 of the tensor's largest magnitude (elements that
  cancel to near zero carry the summation-order noise of their terms);
* the slice: the reference's ``compare_traces`` passes the port's fp8
  trace of reduced ``gpt-paper`` against the reference's own fp8 trace
  (``use_kernel=True``) under its thresholds at the fp8 epsilon.  The
  largest rel-err over threshold seen is 0.0028 for tile128 and 0.016 for
  global; the test holds it below 0.1;
* the control: ``fp8_stale_scale`` flags and localizes to ``layers.0.mlp``
  in both packages.

Batches are 2 x 64 tokens, so each MLP matmul has M = 128 and the tile128
kernel route is taken in both packages.  The CUDA kernel runs only on the
card (``cuda`` marker).
"""
import dataclasses
import fnmatch

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from _torch_parity import jax_setup, one_thread, to_jax_trace, torch_model  # noqa: E402
from repro.bugs import registry as JB  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner, \
    ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.precision import fp8 as J  # noqa: E402
from repro_torch.bugs import registry as TB  # noqa: E402
from repro_torch.core.collector import SECTION_FIELDS  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.kernels import fp8_matmul as TK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.precision import fp8 as T  # noqa: E402

SEQ = 64                       # 2 x 64 tokens: M = 128 in every MLP matmul
EPS = MACHINE_EPS["float8_e4m3fn"]
STALE = "fp8_stale_scale"


def setup_module():
    one_thread()


def _bytes_j(q):
    return np.asarray(q).view(np.uint8)


def _bytes_t(q):
    return q.view(torch.uint8).numpy()


def _f8_pair(shape, seed):
    """An e4m3 array as (jax array, torch tensor) with the same bytes."""
    rng = np.random.default_rng(seed)
    b = (8 * rng.standard_normal(shape)).astype(ml_dtypes.float8_e4m3fn)
    raw = b.view(np.uint8)
    return jnp.asarray(b), torch.from_numpy(raw.copy()).view(torch.float8_e4m3fn)


# ---------------------------------------------------------------------------
# (a) quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", J.FP8_RECIPES)
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 256), (224, 128), (2, 64, 256)],
                         ids=["tiled", "ragged224", "batched"])
def test_quantize_is_byte_identical(recipe, stale, dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10)).astype(np.float32)
    qj, sj = J.quantize_e4m3(jnp.asarray(x).astype(dtype), recipe, stale)
    qt, st = T.quantize_e4m3(torch.from_numpy(x).to(getattr(torch, dtype)),
                             recipe, stale)
    assert qt.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes_t(qt), _bytes_j(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rounds_ties_to_even_and_clips_as_the_reference():
    # amax 448 gives scale 1: x / scale is x, so the cast itself is tested
    # on every e4m3 value, every midpoint and the floats either side of it
    vals = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.unique(vals.astype(np.float32)[np.isfinite(vals.astype(np.float32))])
    mids = (vals[:-1] + vals[1:]) / 2
    x = np.concatenate([vals, mids, np.nextafter(mids, np.float32(np.inf)),
                        np.nextafter(mids, np.float32(-np.inf))])
    x = np.concatenate([x, np.zeros(-len(x) % 128, np.float32)])
    x = x.astype(np.float32).reshape(-1, 128)
    assert np.abs(x).max() == np.float32(448.0)
    for recipe in ("global", "tile128"):
        qj, _ = J.quantize_e4m3(jnp.asarray(x), recipe)
        qt, st = T.quantize_e4m3(torch.from_numpy(x), recipe)
        np.testing.assert_array_equal(_bytes_t(qt), _bytes_j(qj))
    # stale scale: amax halves, so the top of the range clips at +-448
    qt, _ = T.quantize_e4m3(torch.from_numpy(x), "global", stale_scale=True)
    assert float(qt.float().abs().max()) == 448.0


def test_ragged_tiles_keep_their_true_128_boundary():
    x = np.full((224, 128), 0.01, np.float32)
    x[120, 0] = 100.0                       # large value inside tile 0
    q, s = T.quantize_e4m3(torch.from_numpy(x), "tile128")
    assert tuple(s.shape) == (2, 1)
    full = T.expand_tile_scale(s, x.shape).numpy()
    assert np.all(full[:128] == full[0, 0]) and np.all(full[128:] == full[-1, 0])
    np.testing.assert_array_equal(
        full, np.asarray(J.expand_tile_scale(jnp.asarray(s.numpy()), x.shape)))
    out = T.fp8_matmul(torch.from_numpy(x), torch.eye(128), "tile128").numpy()
    np.testing.assert_allclose(out[120, 0], 100.0, rtol=0.05)
    np.testing.assert_allclose(out[200, 0], 0.01, rtol=0.05)


# ---------------------------------------------------------------------------
# (b) the plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (64, 256, 192),
                                   (256, 64, 64), (256, 512, 256)])
def test_plain_global_matches_pallas_kernel(M, K, N):
    xj, xt = _f8_pair((M, K), seed=M + K)
    wj, wt = _f8_pair((K, N), seed=K + N + 1)
    want = np.asarray(jops.fp8_matmul(xj, wj))
    got = tops.fp8_matmul(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)


@pytest.mark.parametrize("M,K,N", [(256, 384, 128), (128, 256, 512),
                                   (384, 128, 256)])
def test_plain_tile128_matches_pallas_kernel(M, K, N):
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    qxj, sxj = J.quantize_e4m3(jnp.asarray(x), "tile128")
    qwj, swj = J.quantize_e4m3(jnp.asarray(w), "tile128")
    want = np.asarray(jops.fp8_matmul_tile128(qxj, sxj, qwj, swj))
    qx, sx = T.quantize_e4m3(torch.from_numpy(x), "tile128")
    qw, sw = T.quantize_e4m3(torch.from_numpy(w), "tile128")
    got = tops.fp8_matmul_tile128(qx, sx, qw, sw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # and the reference's per-element dequant path computes the same
    deq = np.asarray(J.fp8_matmul(jnp.asarray(x), jnp.asarray(w), "tile128"))
    np.testing.assert_allclose(got.numpy(), deq, rtol=1e-5, atol=1e-4)


def test_cpu_tensors_take_the_plain_versions_without_launching():
    TK.fp8_matmul.launches = TK.fp8_matmul_tile128.launches = 0
    _, x = _f8_pair((128, 256), seed=3)
    _, w = _f8_pair((256, 128), seed=4)
    assert torch.equal(tops.fp8_matmul(x, w), TK.fp8_matmul_ref(x, w))
    s1 = torch.rand(1, 2) + 0.5
    s2 = torch.rand(2, 1) + 0.5
    assert torch.equal(tops.fp8_matmul_tile128(x, s1, w, s2),
                       TK.fp8_matmul_tile128_ref(x, s1, w, s2))
    assert TK.fp8_matmul.launches == TK.fp8_matmul_tile128.launches == 0


def test_shapes_outside_the_reference_contract_are_rejected():
    _, x = _f8_pair((300, 256), seed=5)
    _, w = _f8_pair((256, 128), seed=6)
    with pytest.raises(ValueError, match="min"):
        tops.fp8_matmul(x, w)                       # 300 % 256
    with pytest.raises(ValueError, match="multiple of 128"):
        tops.fp8_matmul_tile128(x[:100], torch.ones(1, 2), w, torch.ones(2, 1))
    with pytest.raises(ValueError, match="sx shape"):
        tops.fp8_matmul_tile128(x[:128], torch.ones(2, 2), w, torch.ones(2, 1))
    with pytest.raises(TypeError, match="float8"):
        tops.fp8_matmul(x.float(), w)
    with pytest.raises(ValueError, match="K,N"):
        tops.fp8_matmul(x, w[:128])


# ---------------------------------------------------------------------------
# (c) fp8_linear: forward and straight-through gradients
# ---------------------------------------------------------------------------

def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("recipe", J.FP8_RECIPES)
@pytest.mark.parametrize("shape", [(2, 64, 256), (4, 25, 256)],
                         ids=["tileable", "rows100"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_fp8_linear_forward_and_gradients_match(recipe, shape, stale):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.05 * rng.standard_normal((shape[-1], 512))).astype(np.float32)
    g = rng.standard_normal(shape[:-1] + (512,)).astype(np.float32)

    def jf(x, w):
        return J.fp8_linear({"w": w}, x, recipe=recipe, stale_scale=stale,
                            use_kernel=True)
    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = T.fp8_linear(tw, tx, recipe=recipe, stale_scale=stale)
    ty.backward(torch.from_numpy(g))
    _close(ty.detach().numpy(), jy)
    _close(tx.grad.numpy(), jgx)
    _close(tw.grad.numpy(), jgw)


def test_precision_and_bug_ids_are_validated():
    with pytest.raises(ValueError, match="unknown fp8 recipe"):
        T.Precision(fp8_recipe="e5m2")
    with pytest.raises(KeyError, match="no_such_bug"):
        T.fp8_precision("tile128", frozenset({"no_such_bug"}))
    p = T.fp8_precision("tile128", frozenset({STALE}))
    assert p == T.Precision("tile128", stale_scale=True)


def test_registry_is_a_copy_of_the_reference():
    assert list(TB.BUGS) == list(JB.BUGS)
    for k, b in TB.BUGS.items():
        assert dataclasses.asdict(b) == dataclasses.asdict(JB.BUGS[k])
    assert TB.bug(STALE).expected_module == "layers.*.mlp"
    fp8 = [b.bug_id for b in TB.available_for({"fp8"})]
    assert fp8 == [b.bug_id for b in JB.available_for({"fp8"})]
    assert STALE in fp8


# ---------------------------------------------------------------------------
# (d) the slice: a port fp8 trace judged by the reference's checker
# ---------------------------------------------------------------------------

def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("recipe", ["tile128", "global"])
def test_port_fp8_trace_passes_reference_checker(recipe):
    _, jm, params, named, batch = jax_setup("gpt-paper", seq=SEQ)
    jopt = JaxAdamW(lr=1e-3)
    st = jopt.init(params)
    thr, _ = estimate_thresholds(jax_runner(jm, params, jopt, st), batch, EPS)
    jtr = J.make_fp8_runner(jm, params, recipe, opt=jopt, opt_state=st,
                            use_kernel=True)(batch)
    run = T.make_fp8_runner(torch_model("gpt-paper", named), recipe,
                            opt=AdamW(lr=1e-3), device="cpu")
    port = to_jax_trace(run(_torch_batch(batch)))
    for sec in SECTION_FIELDS:
        assert list(getattr(port, sec)) == list(getattr(jtr, sec)), sec
    assert port.meta["fwd_order"] == jtr.meta["fwd_order"]
    rep = jax_compare(jtr, port, thr)
    worst = max(rep.records, key=lambda r: r.rel_err / r.threshold)
    ratio = worst.rel_err / worst.threshold
    assert rep.passed and not rep.missing, rep.summary()
    assert ratio < 0.1, (recipe, worst)
    assert port.loss == pytest.approx(jtr.loss, rel=1e-5)


# ---------------------------------------------------------------------------
# (e) the control: the stale-scale cast flags and localizes in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buggy", [False, True], ids=["clean", "stale_scale"])
def test_stale_scale_is_flagged_and_localized_in_both_packages(buggy):
    _, jm, params, named, batch = jax_setup("gpt-paper", seq=SEQ)
    bugs = frozenset({STALE}) if buggy else frozenset()
    jres = jax_check(jax_runner(jm, params),
                     J.make_fp8_runner(jm, params, "tile128", bugs=bugs,
                                       use_kernel=True), batch, eps=EPS)
    model = torch_model("gpt-paper", named)
    tres = ttrace_check(make_model_runner(model, device="cpu"),
                        T.make_fp8_runner(model, "tile128", bugs=bugs,
                                          device="cpu"),
                        _torch_batch(batch), eps=EPS)
    assert tres.passed == jres.passed == (not buggy), tres.summary()
    if buggy:
        assert tres.localized_module == jres.localized_module == "layers.0.mlp"
        assert fnmatch.fnmatch(tres.localized_module,
                               TB.bug(STALE).expected_module)


def test_fp8_runner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = torch_model("gpt-paper")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_fp8_runner(model, "tile128")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(256, 384, 128), (8192, 512, 2048)])
def test_kernels_match_plain_versions_on_the_card(M, K, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen).cuda()
    w = torch.randn(K, N, generator=gen).cuda()
    qx, sx = T.quantize_e4m3(x, "tile128")
    qw, sw = T.quantize_e4m3(w, "tile128")
    before = TK.fp8_matmul_tile128.launches
    k1 = tops.fp8_matmul_tile128(qx, sx, qw, sw)
    k2 = tops.fp8_matmul_tile128(qx, sx, qw, sw)
    assert TK.fp8_matmul_tile128.launches == before + 2
    assert torch.equal(k1, k2)
    p = TK.fp8_matmul_tile128_ref(qx, sx, qw, sw)
    torch.testing.assert_close(k1, p, rtol=1e-5, atol=1e-4)
    qx, _ = T.quantize_e4m3(x)
    qw, _ = T.quantize_e4m3(w)
    g = tops.fp8_matmul(qx, qw)
    torch.testing.assert_close(g, TK.fp8_matmul_ref(qx, qw), rtol=1e-5,
                               atol=1e-2)

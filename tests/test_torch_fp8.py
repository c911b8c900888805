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
  in both packages;
* the CUDA kernel's numerics without the card: every e4m3 code is an f16
  value, a CPU emulation of the kernel's order of summation (f32 partials
  per k16 step, the tile-128 fold) meets ``chip_smoke.py`` phase 7's bound
  on its shapes and operands, and a model of the fp8 tensor cores'
  13-fraction-bit accumulation breaks it; the wrapper's TMA operand rules
  and its launch path, which never falls back.

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


# ---------------------------------------------------------------------------
# (f) the CUDA kernel's numerics and launch path, without the card
# ---------------------------------------------------------------------------

# chip_smoke.py phase 7: (M, K, N) per recipe; case i uses seed i
PHASE7 = {"global": [(8192, 512, 2048), (8192, 2048, 512), (128, 128, 128),
                     (64, 256, 192), (256, 64, 64), (8, 64, 64)],
          "tile128": [(8192, 512, 2048), (8192, 2048, 512), (256, 384, 128)]}
PHASE7_CASES = [(recipe, i, shape) for recipe, shapes in PHASE7.items()
                for i, shape in enumerate(shapes)]
EMU_ROWS = 256                 # rows of x emulated at M 8192 (every 32nd)


def _phase7_operands(M, K, N, recipe, seed):
    """``chip_smoke.fp8_operands``: quantized operands of a seeded product
    (the global scale is x's and w's own, so x is made whole)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K, N, generator=gen) * 0.05
    qx, sx = T.quantize_e4m3(x, recipe)
    qw, sw = T.quantize_e4m3(w, recipe)
    return qx, sx, qw, sw


def _x_column(l):
    """``x_column`` of ``csrc/fp8_matmul.cu``: the x column, within a
    128-deep K block, that feeds logical column l of the block's k16
    steps."""
    return 32 * ((l >> 1) & 3) + 4 * (l >> 4) + 2 * ((l >> 3) & 1) + (l & 1)


def _emulate_kernel(qx, qw, scales=None):
    """The kernel's order of summation on the CPU.  Each k16 step of a
    128-deep K block takes the x columns ``_x_column`` gives it; its 16
    products of two e4m3 values (exact in float64, as is their sum) are
    summed and rounded once to f32, and the steps join an f32 accumulator
    in order.  tile128 (``scales``, one (rows, N) f32 sx * sw per K block):
    a block's 8 steps sum into ``part`` from 0, then acc + sc * part with
    both roundings."""
    x, w = qx.double(), qw.double()
    K = x.shape[1]
    acc = torch.zeros(x.shape[0], w.shape[1])
    for kb in range(-(-K // TK.TILE)):
        part = torch.zeros_like(acc)
        for s in range(TK.TILE // 16):
            cols = [c for c in (kb * TK.TILE + _x_column(16 * s + j)
                                for j in range(16)) if c < K]
            step = (x[:, cols] @ w[cols]).float()
            if scales is None:
                acc = acc + step
            else:
                part = part + step
        if scales is not None:
            acc = acc + scales[kb] * part
    return acc


def _fp8_tensor_core(qx, qw, bits=13):
    """A model of the fp8 wgmma's sum: each k32 step aligns its 32 exact
    products to the largest one's exponent and keeps ``bits`` fraction
    bits, truncating; the step's sum joins an f32 accumulator (promotion
    after every k32 step)."""
    x, w = qx.double(), qw.double()
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], 32):
        p = x[:, k0:k0 + 32, None] * w[None, k0:k0 + 32]
        big = p.abs().amax(1, keepdim=True)
        e = torch.floor(torch.log2(torch.where(big > 0, big, 1.0)))
        q = torch.ldexp(torch.ones_like(e), (e - bits).to(torch.int32))
        acc = acc + (torch.trunc(p / q) * q).sum(1).float()
    return acc


def _phase7_over(got, xd, wd):
    """Largest |got - f64| over phase 7's bound K 2^-23 (|xd| @ |wd|)."""
    ref = xd @ wd
    bound = xd.shape[1] * 2.0 ** -23 * (xd.abs() @ wd.abs())
    return float(((got.double() - ref).abs() / bound).max())


def test_every_e4m3_code_is_an_f16_value():
    q = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    f32, f16 = q.float(), q.to(torch.float16)
    nan = torch.isnan(f32)
    assert int(nan.sum()) == 2                     # 0x7f and 0xff
    assert torch.equal(torch.isnan(f16), nan)
    assert torch.equal(f16.float()[~nan], f32[~nan])
    want = q.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    np.testing.assert_array_equal(f16.numpy(), want.astype(np.float16))


@pytest.mark.parametrize("recipe,seed,shape", PHASE7_CASES,
                         ids=[f"{r}-{'x'.join(map(str, s))}"
                              for r, _, s in PHASE7_CASES])
def test_kernel_summation_order_meets_the_card_bound(recipe, seed, shape):
    M, K, N = shape
    qx, sx, qw, sw = _phase7_operands(M, K, N, recipe, seed)
    rows = torch.arange(0, M, max(1, M // EMU_ROWS))
    xq = qx[rows]
    xd, wd = xq.double(), qw.double()
    scales = None
    if recipe == "tile128":
        xd = xd * T.expand_tile_scale(sx, qx.shape)[rows].double()
        wd = wd * T.expand_tile_scale(sw, qw.shape).double()
        scales = [(sx[:, kb, None] * sw[None, kb, :])
                  .repeat_interleave(TK.TILE, 0)
                  .repeat_interleave(TK.TILE, 1)[rows]
                  for kb in range(K // TK.TILE)]
    assert sorted(_x_column(l) for l in range(TK.TILE)) == list(range(TK.TILE))
    assert _phase7_over(_emulate_kernel(xq, qw, scales), xd, wd) <= 1.0


def test_fp8_tensor_core_accumulation_breaks_the_card_bound():
    over = {}
    for i, (M, K, N) in enumerate(PHASE7["global"]):
        if M * K * N > 2 ** 24:
            continue                               # the small shapes suffice
        qx, _, qw, _ = _phase7_operands(M, K, N, "global", i)
        over[(M, K, N)] = _phase7_over(_fp8_tensor_core(qx, qw), qx.double(),
                                       qw.double())
        # the f16 route meets it on the same operands
        assert _phase7_over(_emulate_kernel(qx, qw), qx.double(),
                            qw.double()) <= 1.0
    assert len(over) == 4 and max(over.values()) > 1.0, over


def test_kernel_operands_meet_tma_rules():
    _, x = _f8_pair((64, 8), seed=10)
    _, w = _f8_pair((8, 64), seed=11)
    # K 8 and N 8 are within the reference's contract, so the CPU route
    # takes them, while TMA needs rows of 16-byte multiples
    assert torch.equal(tops.fp8_matmul(x, w), TK.fp8_matmul_ref(x, w))
    with pytest.raises(ValueError, match="multiples of 16"):
        TK.check_kernel_operands(x, torch.zeros(8, 16, dtype=TK.F8))
    _, x = _f8_pair((64, 64), seed=12)
    _, w = _f8_pair((64, 64), seed=13)
    with pytest.raises(ValueError, match="multiples of 16"):
        TK.check_kernel_operands(x, w[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        TK.check_kernel_operands(x, w.t())
    flat = torch.zeros(64 * 64 + 8, dtype=torch.uint8)
    shifted = flat[8:].view(TK.F8).view(64, 64)      # 8 bytes past 16
    assert shifted.data_ptr() % 16 == 8 and shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        TK.check_kernel_operands(shifted, w)
    with pytest.raises(ValueError, match="contiguous"):
        TK.check_kernel_operands(x, w, (torch.ones(4, 2).t(), torch.ones(1)))
    # what passes TMA's rules goes on to the device check
    with pytest.raises(ValueError, match="CUDA device"):
        TK.check_kernel_operands(x, w)


def test_kernel_launch_never_falls_back(monkeypatch):
    calls, rc = [], [0]

    def fake_lib():
        def fn(*args):
            calls.append(args)
            return rc[0]
        return fn
    monkeypatch.setattr(TK, "_lib", fake_lib)
    _, x = _f8_pair((128, 256), seed=14)
    _, w = _f8_pair((256, 128), seed=15)
    sx, sw = torch.ones(1, 2), torch.ones(2, 1)
    out = torch.empty(128, 128)
    w16 = torch.empty(TK.widened_rows(256), 128, dtype=torch.float16)
    assert TK.widened_rows(64) == TK.widened_rows(128) == 128
    before = (TK.fp8_matmul.launches, TK.fp8_matmul_tile128.launches)
    TK._run(x, w, None, None, out, w16, stream=0)
    TK._run(x, w, sx, sw, out, w16, stream=0)
    assert calls == [
        (x.data_ptr(), w.data_ptr(), w16.data_ptr(), None, None,
         out.data_ptr(), 128, 128, 256, 0, 0),
        (x.data_ptr(), w.data_ptr(), w16.data_ptr(), sx.data_ptr(),
         sw.data_ptr(), out.data_ptr(), 128, 128, 256, 1, 0)]
    assert (TK.fp8_matmul.launches,
            TK.fp8_matmul_tile128.launches) == (before[0] + 1, before[1] + 1)
    rc[0] = 719                                   # a failed launch
    with pytest.raises(RuntimeError, match="tile128 kernel failed: CUDA "
                                           "error 719"):
        TK._run(x, w, sx, sw, out, w16, stream=0)
    with pytest.raises(RuntimeError, match="fp8_matmul kernel failed"):
        TK._run(x, w, None, None, out, w16, stream=0)
    assert len(calls) == 4                        # no second attempt
    assert (TK.fp8_matmul.launches,
            TK.fp8_matmul_tile128.launches) == (before[0] + 1, before[1] + 1)


CARD_GLOBAL = [(256, 512, 128), (8192, 512, 2048)]


def _card_global_operands(M, K, N):
    """The global half of ``test_kernels_match_plain_versions_on_the_card``:
    N(0,1) operands quantized with their own global scales."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K, N, generator=gen)
    return T.quantize_e4m3(x)[0], T.quantize_e4m3(w)[0]


def _misses(got, want, rtol=1e-5, atol=1e-2):
    """Elements of ``got`` outside ``assert_close``'s tolerance of ``want``
    (the tolerance the card test's global half once held the kernel to,
    against the plain version)."""
    got, want = got.double(), want.double()
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


@pytest.mark.parametrize("M,K,N", CARD_GLOBAL,
                         ids=["x".join(map(str, s)) for s in CARD_GLOBAL])
def test_card_global_tolerance_is_finer_than_f32_rounding(M, K, N):
    """Why the card test's global half is held to phase 7's bound: it once
    held the global kernel to the plain version, an f32 product, at atol
    1e-2.  Its operands are unscaled e4m3 values whose
    sums reach some 1e6, where f32's spacing is 0.0625 or more, so two f32
    sums in different orders miss that tolerance on some elements whose
    result cancels to near zero: the sequential order (each exact product
    added in turn, as an FMA loop sums) misses it against the correctly
    rounded product, and so does the kernel's order.  Both orders meet
    phase 7's bound on the same operands."""
    qx, qw = _card_global_operands(M, K, N)
    rows = torch.arange(0, M, max(1, M // EMU_ROWS))
    xd, wd = qx[rows].double(), qw.double()
    spacing = torch.finfo(torch.float32).eps * float((xd.abs() @ wd.abs())
                                                      .max())
    assert spacing > 10 * 1e-2
    rounded = (xd @ wd).float()
    xf = qx[rows].float()
    seq = torch.zeros(len(rows), N)
    for k in range(K):
        seq = seq + xf[:, k, None] * qw[k].float()   # each product is exact
    kernel = _emulate_kernel(qx[rows], qw)
    assert _misses(seq, rounded) > 0
    assert _misses(kernel, seq) > 0
    assert _phase7_over(seq, xd, wd) <= 1.0
    assert _phase7_over(kernel, xd, wd) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("recipe,M,K,N", [
    ("tile128", 256, 384, 128), ("tile128", 8192, 512, 2048),
    ("global", 256, 512, 128), ("global", 8192, 512, 2048)])
def test_kernels_match_plain_versions_on_the_card(recipe, M, K, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, generator=gen).cuda()
    w = torch.randn(K, N, generator=gen).cuda()
    if recipe == "tile128":
        qx, sx = T.quantize_e4m3(x, "tile128")
        qw, sw = T.quantize_e4m3(w, "tile128")
        before = TK.fp8_matmul_tile128.launches
        k1 = tops.fp8_matmul_tile128(qx, sx, qw, sw)
        k2 = tops.fp8_matmul_tile128(qx, sx, qw, sw)
        assert TK.fp8_matmul_tile128.launches == before + 2
        assert torch.equal(k1, k2)
        p = TK.fp8_matmul_tile128_ref(qx, sx, qw, sw)
        torch.testing.assert_close(k1, p, rtol=1e-5, atol=1e-4)
        return
    qx, _ = T.quantize_e4m3(x)
    qw, _ = T.quantize_e4m3(w)
    before = TK.fp8_matmul.launches
    g = tops.fp8_matmul(qx, qw)
    assert torch.equal(g, tops.fp8_matmul(qx, qw))
    assert TK.fp8_matmul.launches == before + 2
    # the unscaled sums reach some 1e6, where no f32 order meets a fixed
    # atol (test_card_global_tolerance_is_finer_than_f32_rounding): both
    # versions are held to phase 7's bound against float64
    xd, wd = qx.double(), qw.double()
    assert _phase7_over(g, xd, wd) <= 1.0
    assert _phase7_over(TK.fp8_matmul_ref(qx, qw), xd, wd) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", CARD_GLOBAL,
                         ids=["x".join(map(str, s)) for s in CARD_GLOBAL])
def test_card_global_plain_version_misses_its_tolerance_too(M, K, N):
    """On the card, the plain version (an f32 product by the library) also
    misses the global tolerance against the correctly rounded product,
    while the kernel meets phase 7's bound on the same operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    qx, qw = _card_global_operands(M, K, N)
    xd, wd = qx.double(), qw.double()
    rounded = (xd @ wd).float()
    qx, qw = qx.cuda(), qw.cuda()
    plain = TK.fp8_matmul_ref(qx, qw).cpu()
    kernel = tops.fp8_matmul(qx, qw).cpu()
    assert _misses(plain, rounded) > 0
    assert _phase7_over(kernel, xd, wd) <= 1.0


"""The port's packed rel-err reduction against the reference's oracles.

Both packages pack at the same block, 1024 elements.  The reference's
Pallas kernel is not run (its interpret mode fails on jax 0.9: no `pl.load`);
the port's plain version is held against the kernel's own oracle,
``relerr.packed_sq_norms_xla``, and the float64 ``rel_err_np``, rtol 1e-6.
The single-pair wrappers (``sq_norms``, ``rel_err_fused``, ``ops.rel_err``)
pack one pair at the reference's 65536 elements a block; their layout is
held to the one the reference's ``sq_norms`` builds and reduced by
``packed_sq_norms_xla``.  The CUDA kernel itself runs only on the card
(``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_thread  # noqa: E402
from repro.core import relerr_engine as JE  # noqa: E402
from repro.kernels import relerr as JK  # noqa: E402
from repro_torch.core import relerr_engine as TE  # noqa: E402
from repro_torch.core import thresholds as TT  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import relerr as TK  # noqa: E402

BLOCK = TK.DEFAULT_BLOCK
SIZES = [1, BLOCK - 1, BLOCK, BLOCK + 1, 3 * BLOCK + 17, 5]


def setup_module():
    one_thread()


def _pairs(sizes, seed=0, rel=1e-3):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        a = (rng.standard_normal(n) * rng.uniform(0.01, 10)).astype(np.float32)
        b = (a + rel * rng.standard_normal(n)).astype(np.float32)
        out.append((a, b))
    return out


def _pack_torch(pairs, dtype=torch.float32):
    return TE.pack_device([torch.from_numpy(a).to(dtype) for a, _ in pairs],
                          [torch.from_numpy(b).to(dtype) for _, b in pairs])


def test_block_matches_reference():
    assert TK.DEFAULT_BLOCK == JK.DEFAULT_BLOCK == 1024


def test_pack_device_layout_matches_jax():
    pairs = _pairs(SIZES + [0])
    t = _pack_torch(pairs)
    j = JE.pack_device([jnp.asarray(a) for a, _ in pairs],
                       [jnp.asarray(b) for _, b in pairs])
    for tt, jj in zip(t, j):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))
    assert t[2].dtype == t[3].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_xla_oracle_and_float64(seed):
    pairs = _pairs(SIZES, seed=seed)
    af, bf, seg, cnt = _pack_torch(pairs)
    got = TK.packed_sq_norms_ref(af, bf, seg, cnt, n_segments=len(pairs))
    orac = JK.packed_sq_norms_xla(jnp.asarray(af.numpy()),
                                  jnp.asarray(bf.numpy()),
                                  jnp.asarray(seg.numpy()), len(pairs))
    np.testing.assert_allclose(got.numpy(), np.asarray(orac), rtol=1e-6)
    errs = TE._to_rel_err(got.numpy().astype(np.float64))
    want = [JE.rel_err_np(a, b) for a, b in pairs]
    np.testing.assert_allclose(errs, want, rtol=1e-6)


def test_bf16_leaves_are_packed_as_f32():
    pairs = _pairs(SIZES, seed=3)
    got = TE.section_sq_norms([torch.from_numpy(a).bfloat16() for a, _ in pairs],
                              [torch.from_numpy(b).bfloat16() for _, b in pairs],
                              mode="packed")
    want = TE.section_sq_norms([torch.from_numpy(a).bfloat16() for a, _ in pairs],
                               [torch.from_numpy(b).bfloat16() for _, b in pairs],
                               mode="loop")
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pad_nan_is_masked_and_real_nan_propagates():
    n = BLOCK + 5
    af = torch.full((2 * BLOCK,), float("nan"))
    bf = torch.full((2 * BLOCK,), float("inf"))
    af[:n], bf[:n] = 1.0, 2.0
    seg = torch.tensor([0, 0], dtype=torch.int32)
    cnt = torch.tensor([BLOCK, n - BLOCK], dtype=torch.int32)
    out = TK.packed_sq_norms(af, bf, seg, cnt, n_segments=1)
    np.testing.assert_allclose(out[0].numpy(), [n, n], rtol=1e-6)
    af[3] = float("nan")
    out = TK.packed_sq_norms(af, bf, seg, cnt, n_segments=1)
    assert torch.isnan(out[0]).all()


def test_zero_reference_gives_absolute_error():
    a = {"z": torch.zeros(16), "e": torch.zeros(0), "x": torch.ones(3)}
    b = {"z": torch.full((16,), 0.5), "e": torch.zeros(0), "x": torch.ones(3)}
    for mode in ("packed", "loop"):
        got = TE.batched_rel_err(a, b, mode=mode)
        assert got == pytest.approx({"z": 2.0, "e": 0.0, "x": 0.0})


def test_cpu_tensors_take_the_plain_version_without_launching():
    TK.packed_sq_norms.launches = 0
    pairs = _pairs(SIZES, seed=4)
    got = TK.packed_sq_norms(*_pack_torch(pairs), n_segments=len(pairs))
    want = TK.packed_sq_norms_ref(*_pack_torch(pairs), n_segments=len(pairs))
    assert torch.equal(got, want)
    TE.batched_rel_err({"t": torch.ones(5000)}, {"t": torch.zeros(5000)})
    assert TK.packed_sq_norms.launches == 0


def test_auto_mode_selects_loop_for_tiny_sections():
    small = TE.section_sq_norms([torch.ones(8)], [torch.zeros(8)])
    assert small.dtype == np.float64 and small.tolist() == [[8.0, 8.0]]
    with pytest.raises(ValueError):
        TE.section_sq_norms([torch.ones(8)], [torch.zeros(8)], mode="nope")


def test_malformed_layout_is_rejected():
    af, bf, seg, cnt = _pack_torch(_pairs([BLOCK + 3]))
    with pytest.raises(ValueError):
        TK.packed_sq_norms(af[:-1], bf[:-1], seg, cnt, n_segments=1)
    with pytest.raises(TypeError):
        TK.packed_sq_norms(af.double(), bf.double(), seg, cnt, n_segments=1)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pairs = _pairs(SIZES + [2_000_003], seed=5)
    args = [t.cuda() for t in _pack_torch(pairs)]
    before = TK.packed_sq_norms.launches
    k1 = TK.packed_sq_norms(*args, n_segments=len(pairs))
    k2 = TK.packed_sq_norms(*args, n_segments=len(pairs))
    assert TK.packed_sq_norms.launches == before + 2
    assert torch.equal(k1, k2)
    p = TK.packed_sq_norms_ref(*args, n_segments=len(pairs))
    np.testing.assert_allclose(k1.cpu().numpy(), p.cpu().numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# the per-pair helpers and the single-pair layout
# ---------------------------------------------------------------------------

SINGLE = TK.SINGLE_PAIR_BLOCK
SINGLE_SIZES = [1, SINGLE - 1, SINGLE, SINGLE + 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_pair_helpers_match_the_reference(dtype):
    pairs = _pairs([1, 7, SINGLE + 3, 200_001], seed=8)
    for a, b in pairs:
        ta = torch.from_numpy(a).to(dtype)
        tb = torch.from_numpy(b).to(dtype)
        na, nb = ta.float().numpy(), tb.float().numpy()
        want = JE.rel_err_np(na, nb)
        for got in (TE.rel_err_np(na, nb), TT.rel_err(na, nb),
                    TO.rel_err(ta, tb), TK.rel_err_fused(ta, tb),
                    TK.rel_err_ref(ta, tb)):
            assert got == pytest.approx(want, rel=1e-6)


def test_zero_reference_gives_the_norm_of_b():
    a = torch.zeros(3000)
    b = torch.linspace(-1, 2, 3000)
    want = float(np.linalg.norm(b.numpy().astype(np.float64)))
    for f in (TO.rel_err, TK.rel_err_ref):
        assert f(a, b) == pytest.approx(want, rel=1e-6)
    assert TE.rel_err_np(a.numpy(), b.numpy()) == pytest.approx(want)
    assert TO.rel_err(torch.zeros(0), torch.zeros(0)) == 0.0


def _reference_single_layout(a, b, block):
    """The layout the reference's ``sq_norms`` builds (its lines, in jnp)."""
    af = jnp.asarray(a).reshape(-1).astype(jnp.float32)
    bf = jnp.asarray(b).reshape(-1).astype(jnp.float32)
    n = af.shape[0]
    pad = -n % block if n else block
    if pad:
        af = jnp.pad(af, (0, pad))
        bf = jnp.pad(bf, (0, pad))
    nb = af.shape[0] // block
    seg_ids = jnp.zeros((nb,), jnp.int32)
    counts = jnp.clip(n - jnp.arange(nb, dtype=jnp.int32) * block, 0, block)
    return af, bf, seg_ids, counts


@pytest.mark.parametrize("n", SINGLE_SIZES)
def test_single_pair_layout_matches_the_reference(n):
    (a, b), = _pairs([n], seed=n)
    got = TK.single_pair_layout(torch.from_numpy(a), torch.from_numpy(b))
    want = _reference_single_layout(a, b, SINGLE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == got[3].dtype == torch.int32
    d2, a2 = TK.sq_norms(torch.from_numpy(a), torch.from_numpy(b))
    orac = JK.packed_sq_norms_xla(*want[:3], 1, block=SINGLE)
    np.testing.assert_allclose([float(d2), float(a2)],
                               np.asarray(orac)[0], rtol=1e-6)


def test_single_pair_copies_bf16_and_strided_leaves_to_f32():
    x = torch.randn(300, 500)
    a, b = x.t(), (x + 1e-2).t()           # strided views
    assert not a.is_contiguous()
    af, bf, _, cnt = TK.single_pair_layout(a.bfloat16(), b)
    assert af.dtype == bf.dtype == torch.float32 and af.is_contiguous()
    assert torch.equal(af[:a.numel()], a.bfloat16().float().reshape(-1))
    assert torch.equal(bf[:b.numel()], b.reshape(-1))
    assert int(cnt.sum()) == a.numel() and not bool(af[a.numel():].any())
    with pytest.raises(ValueError):
        TK.single_pair_layout(torch.ones(3), torch.ones(4))


def test_blas_mode_matches_the_reference_executor():
    pairs = _pairs(SIZES + [20_000], seed=9)
    got = TE.section_sq_norms([torch.from_numpy(a) for a, _ in pairs],
                              [torch.from_numpy(b) for _, b in pairs],
                              mode="blas")
    want = JE._blas_path([a for a, _ in pairs], [b for _, b in pairs])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bf = TE.section_sq_norms([torch.from_numpy(a).bfloat16() for a, _ in pairs],
                             [torch.from_numpy(b).bfloat16() for _, b in pairs],
                             mode="blas")
    loop = TE.section_sq_norms([torch.from_numpy(a).bfloat16() for a, _ in pairs],
                               [torch.from_numpy(b).bfloat16() for _, b in pairs],
                               mode="loop")
    np.testing.assert_allclose(bf, loop, rtol=1e-5)


def test_fused_mode_is_refused_naming_packed():
    with pytest.raises(ValueError, match="packed"):
        TE.section_sq_norms([torch.ones(8)], [torch.zeros(8)], mode="fused")


@pytest.mark.cuda
def test_blas_mode_on_the_card_is_refused_naming_packed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the refusal is of a CUDA tensor")
    x = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="packed"):
        TE.section_sq_norms([x], [x], mode="blas")

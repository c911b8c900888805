"""The port's packed rel-err reduction against the reference's oracles.

Both packages pack at the same block, 1024 elements.  The reference's
Pallas kernel is not run (its interpret mode fails on jax 0.9: no `pl.load`);
the port's plain version is held against the kernel's own oracle,
``relerr.packed_sq_norms_xla``, and the float64 ``rel_err_np``, rtol 1e-6.
The CUDA kernel itself runs only on the card (``cuda`` marker).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_thread  # noqa: E402
from repro.core import relerr_engine as JE  # noqa: E402
from repro.kernels import relerr as JK  # noqa: E402
from repro_torch.core import relerr_engine as TE  # noqa: E402
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
        TE.section_sq_norms([torch.ones(8)], [torch.zeros(8)], mode="blas")


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

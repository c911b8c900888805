"""The port's emulated collectives and conjugate operators against the
reference's under ``shard_map`` on 8 forced host devices, forward and
gradient.

Each op runs on every rank of a (dp 2, cp 2, tp 2) mesh.  The gradient is
each rank's vector-Jacobian product with its own cotangent, as the
reference's candidate takes ``jax.grad`` of each rank's loss inside
``shard_map``.  Tolerance: the sums run over at most 4 ranks of terms no
larger than M = max |x| (or max |ct|), in f32, in an order that may differ
from XLA's; 3 roundings of a sum no larger than 4M stay under 2^-20 M, the
absolute tolerance (a sum of two ranks is exact either way)."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402
from repro.parallel import layers as jl  # noqa: E402
from repro_torch.parallel import layers as tl  # noqa: E402
from repro_torch.parallel.mesh import Mesh  # noqa: E402

LOCAL = (2, 8, 4)      # a rank's (B, S, d)


def setup_module():
    one_thread()


@pytest.fixture(scope="module")
def jmesh(forced_devices):
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                 ("dp", "cp", "tp"))


def _jax_per_rank(jmesh, fn, x, ct):
    """Every rank's ``fn(x)`` and its vjp with ``ct`` (rank-stacked)."""
    from jax.sharding import PartitionSpec as P
    from repro.parallel.api import shard_map_unchecked
    ranks = P(("dp", "cp", "tp"))

    def body(x, ct):
        y, vjp = jax.vjp(fn, x[0])
        return y[None], vjp(ct[0])[0][None]

    y, g = shard_map_unchecked(body, jmesh, in_specs=(ranks, ranks),
                               out_specs=(ranks, ranks))(x, ct)
    return np.asarray(y), np.asarray(g)


def _port_per_rank(fn, x, ct):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


OPS = {
    "g_copy": (jl.g_copy, lambda m, x: tl.g_copy(m, x)),
    "g_reduce": (jl.g_reduce, lambda m, x: tl.g_reduce(m, x)),
    "g_reduce_over_dp_cp": (lambda x: jl.g_reduce_over(x, ("dp", "cp")),
                            lambda m, x: tl.g_reduce_over(m, x, ("dp", "cp"))),
    "sp_gather": (jl.sp_gather, lambda m, x: tl.sp_gather(m, x)),
    "sp_scatter": (jl.sp_scatter, lambda m, x: tl.sp_scatter(m, x)),
    "cp_all_gather": (
        lambda x: jax.lax.all_gather(x, "cp", axis=1, tiled=True),
        lambda m, x: m.all_gather(x, "cp", dim=1)),
    "psum_dp": (lambda x: jax.lax.psum(x, "dp"),
                lambda m, x: m.psum(x, "dp")),
    "one_rank_tp": (lambda x: jl.one_rank(x, "tp"),
                    lambda m, x: tl.one_rank(m, x, "tp")),
    "one_rank_cp": (lambda x: jl.one_rank(x, "cp"),
                    lambda m, x: tl.one_rank(m, x, "cp")),
    "one_rank_dp": (lambda x: jl.one_rank(x, "dp"),
                    lambda m, x: tl.one_rank(m, x, "dp")),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_matches_shard_map(jmesh, op):
    jfn, tfn = OPS[op]
    mesh = Mesh(2, 2, 2, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8,) + LOCAL).astype(np.float32)
    y_shape = tfn(mesh, torch.from_numpy(x)).shape
    ct = rng.standard_normal(tuple(y_shape)).astype(np.float32)
    jy, jg = _jax_per_rank(jmesh, jfn, x, ct)
    ty, tg = _port_per_rank(lambda t: tfn(mesh, t), x, ct)
    np.testing.assert_allclose(ty, jy, rtol=0, atol=2**-20 * np.abs(x).max())
    np.testing.assert_allclose(tg, jg, rtol=0, atol=2**-20 * np.abs(ct).max())


def test_pmax_and_local_positions_match_shard_map(jmesh):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.parallel.api import shard_map_unchecked
    ranks = P(("dp", "cp", "tp"))
    mesh = Mesh(2, 2, 2, device="cpu")
    x = np.random.default_rng(1).standard_normal((8, 3, 5)).astype(np.float32)
    S = 16

    def body(x):
        return (jax.lax.pmax(x[0], "tp")[None],
                jl.local_positions(S, 2)[None].astype(jnp.int32))

    jm, jpos = shard_map_unchecked(body, jmesh, in_specs=(ranks,),
                                   out_specs=(ranks, ranks))(x)
    np.testing.assert_array_equal(mesh.pmax(torch.from_numpy(x), "tp").numpy(),
                                  np.asarray(jm))
    np.testing.assert_array_equal(tl.local_positions(mesh, S).numpy(),
                                  np.asarray(jpos))
    flat = Mesh(2, 1, 2, device="cpu")
    assert torch.equal(tl.local_positions(flat, S),
                       torch.arange(S).expand(4, S))


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_zigzag_helpers_match_reference(cp):
    assert tl.zigzag_order(cp) == jl.zigzag_order(cp)
    x = np.arange(2 * 16 * 3, dtype=np.float32).reshape(2, 16, 3)
    z = np.array(jl.permute_to_zigzag(x, cp, 1))
    np.testing.assert_array_equal(
        tl.permute_to_zigzag(torch.from_numpy(x), cp, 1).numpy(), z)
    np.testing.assert_array_equal(
        tl.permute_from_zigzag(torch.from_numpy(z), cp, 1).numpy(), x)


def test_candidate_layout_matches_shard_map_placement(jmesh):
    """The runner shards a sequence tap as the reference's ``PartitionSpec``
    places it: contiguous blocks of the zigzag-permuted sequence, cp-major
    and sp-minor.  Under zigzag cp with sp that is not the placement
    ``slices_for_rank`` gives the annotation, so the runner shards and
    assembles with ``_Plumbing.layout_spec`` and ``unzig``."""
    from jax.sharding import PartitionSpec as P
    from repro.parallel.api import shard_map_unchecked
    from _torch_parity import configs
    from repro_torch.core.generator import extract_shard
    from repro_torch.parallel.api import ParallelConfig, _Plumbing

    pl = _Plumbing(configs("gpt-paper")[1],
                   ParallelConfig(dp=2, cp=2, tp=2, sp=True), "cpu")
    name = "layers.0.mlp/input"
    full = np.random.default_rng(2).standard_normal((4, 16, 6)).astype(
        np.float32)
    zig = np.array(jl.permute_to_zigzag(full, 2, 1))
    local = shard_map_unchecked(lambda x: x[None], jmesh,
                                in_specs=(P("dp", ("cp", "tp")),),
                                out_specs=P(("dp", "cp", "tp")))(zig)
    ours = pl.act_in(name, torch.from_numpy(full))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(local))
    np.testing.assert_array_equal(pl.act_out(name, ours).numpy(), full)
    spec, sizes = pl.ann.act_spec(name), pl.sizes
    annotated = extract_shard(full, spec, sizes,
                              {"dp": 0, "cp": 0, "tp": 1, "sp": 1})
    assert not np.array_equal(annotated, np.asarray(local)[1])

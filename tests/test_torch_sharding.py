"""The port's sharding rules, meshes and HLO parser
(``repro_torch.sharding.rules``, ``launch/mesh.py``, ``launch/hlo.py``)
against the JAX package's, on the CPU.

* For all eleven configs on both production meshes, (16,16) and
  (2,16,16), on the reference's fake-mesh pattern: every parameter leaf
  (the port's meta-built per-layer leaves and the reference's
  ``jax.eval_shape`` scan-stacked ones) gets the same ``param_pspec`` and
  ``with_data_axis`` from both packages; so does every batch of
  ``INPUT_SHAPES`` (``batch_pspec``), every cache leaf of each decode
  shape (``cache_pspec``, the port's per-layer caches and the reference's
  stacked ones) and ``dispatch_groups``.
* Per-device argument bytes: the dry run's sums (``launch/dryrun``'s
  ``param_bytes`` over the port's leaves) equal sums built with the
  reference's rules over the reference's trees, parameters exactly; the
  f32 optimizer state too but where the stacked layer dim is the only
  dim left for the data axes (a bias or norm whose one dim the model axis
  takes, on five leaf groups of four configs): the reference shards the
  layer dim over data, the port's per-layer leaf stays whole, dp times
  the reference's bytes.  Token batches are int64 in the port, int32 in
  the reference: twice the bytes.
* ``parse_hlo_collectives`` gives the reference's report on the
  reference test's HLO fixture and on the HLO jax compiles for a
  ``shard_map`` psum over 8 host devices.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import list_configs as jax_list_configs  # noqa: E402
from repro.core.collector import flatten_named as jax_flatten  # noqa: E402
from repro.launch import hlo as jhlo  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.checkpoint.store import flatten_named  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, get_config, \
    list_configs  # noqa: E402
from repro_torch.core.collector import named_params  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo as thlo  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (ShapeMesh, make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

# the configs both packages have (the port adds moonlight-16b-a3b, which
# the reference has no config for)
ALL = tuple(sorted(set(list_configs()) & set(jax_list_configs())))


class _Single:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class _Multi:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


MESHES = {"single": _Single, "multi": _Multi}


def setup_module():
    one_thread()


def _jax_leaves(name):
    sds = jax.eval_shape(JaxModel(jax_get_config(name)).init,
                         jax.random.PRNGKey(0))
    return {k: (tuple(v.shape), v.dtype) for k, v in
            jax_flatten(sds).items()}


def _port_leaves(name):
    model = Model(get_config(name), device="meta")
    leaves = named_params(model)
    assert all(p.is_meta for p in leaves.values())
    return leaves


def _groups(port: dict, ref: dict) -> dict:
    """Reference name -> the port leaves it stacks (``layers.{i}.x`` under
    the scanned ``layers.x``)."""
    out = {}
    for k, v in port.items():
        m = re.match(r"^(layers|dense_layers|mamba\d+)\.\d+\.(.*)$", k)
        key = k
        if m and f"{m.group(1)}.{m.group(2)}" in ref:
            key = f"{m.group(1)}.{m.group(2)}"
        out.setdefault(key, []).append((k, v))
    return out


def _shard_bytes(shape, spec, mesh, itemsize) -> int:
    n = math.prod(shape)
    for e in spec:
        for a in () if e is None else ((e,) if isinstance(e, str) else e):
            n //= mesh.shape[a]
    return n * itemsize


def _opt_spec(rules, name, shape, mesh):
    return rules.with_data_axis(rules.param_pspec(name, shape, mesh), shape,
                                mesh, rules.dp_axes(mesh))


@pytest.mark.parametrize("name", ALL)
def test_param_specs_match_the_reference(name):
    port, ref = _port_leaves(name), _jax_leaves(name)
    groups = _groups(port, ref)
    assert set(groups) == set(ref)
    cases = [(k, tuple(v.shape)) for k, v in port.items()] + \
        [(k, s) for k, (s, _) in ref.items()]
    for mesh in MESHES.values():
        for k, shape in cases:
            jspec = jrules.param_pspec(k, shape, mesh)
            tspec = trules.param_pspec(k, shape, mesh)
            assert tuple(tspec) == tuple(jspec), (k, shape)
            for axes in (("data",), jrules.dp_axes(mesh)):
                got = trules.with_data_axis(tspec, shape, mesh, axes)
                want = jrules.with_data_axis(jspec, shape, mesh, axes)
                assert tuple(got) == tuple(want), (k, shape, axes)


@pytest.mark.parametrize("name", ALL)
def test_argument_bytes_match_the_reference(name):
    port, ref = _port_leaves(name), _jax_leaves(name)
    groups = _groups(port, ref)
    for mesh_name, mesh in MESHES.items():
        dp = math.prod(mesh.shape[a] for a in jrules.dp_axes(mesh))
        assert D.param_bytes(port, mesh) == sum(
            _shard_bytes(s, jrules.param_pspec(k, s, mesh), mesh,
                         np.dtype(dt).itemsize) for k, (s, dt) in ref.items())
        want = 0
        for key, (shape, _) in ref.items():
            jspec = _opt_spec(jrules, key, shape, mesh)
            rb = _shard_bytes(shape, jspec, mesh, 4)
            pb = sum(_shard_bytes(tuple(v.shape), _opt_spec(
                trules, k, tuple(v.shape), mesh), mesh, 4)
                for k, v in groups[key])
            if pb != rb:
                # the data axes on the stacked layer dim, and nowhere on the
                # port's per-layer leaf: it stays whole over data
                assert jspec[0] is not None and len(groups[key]) == shape[0]
                assert all(not any(e not in (None, "model") for e in
                                   _opt_spec(trules, k, tuple(v.shape), mesh))
                           for k, v in groups[key]), key
                assert pb == rb * dp, key
            want += pb
        opt_f32 = {k: v.float() for k, v in port.items()}
        assert D.param_bytes(opt_f32, mesh, opt_state=True) == want, mesh_name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_and_bytes_match_the_reference(mesh):
    m = MESHES[mesh]
    for b in (1, 2, 4, 8, 16, 32, 64, 128, 256, 48, 96):
        assert tuple(trules.batch_pspec(m, b)) == \
            tuple(jrules.batch_pspec(m, b)), b
    for sharded in (True, False):
        assert trules.seq_axes_for(m, sharded) == \
            jrules.seq_axes_for(m, sharded)
    for name in ("tinyllama-1.1b", "llava-next-34b", "hubert-xlarge"):
        cfg = get_config(name)
        for key, shape in INPUT_SHAPES.items():
            specs = TS.input_specs(cfg, shape)
            jspecs = JS.input_specs(jax_get_config(name), J_SHAPES[key])
            sharded = shape.global_batch % D.dp_total(m) == 0
            got = D.batch_shardings(specs, m, sharded)
            want = 0
            for k, v in jspecs.items():
                spec = tuple(got[k].spec)
                isz = 8 if v.dtype == jnp.int32 else np.dtype(v.dtype).itemsize
                want += _shard_bytes(v.shape, spec, m, isz)
            assert D.tree_shard_bytes(specs, got) == want, (name, key)


def _ref_batch_dim(leaf_shape):
    """The reference dry run's batch dim of a stacked cache leaf."""
    nd = len(leaf_shape)
    return 0 if nd <= 2 or leaf_shape[0] > 4096 else (
        1 if nd >= 3 and leaf_shape[0] <= 128 else 0)


@pytest.mark.parametrize("name", ALL)
def test_cache_specs_and_dispatch_groups_match_the_reference(name):
    cfg = get_config(name)
    model = Model(cfg, device="meta")
    jm = JaxModel(jax_get_config(name))
    for key, shape in INPUT_SHAPES.items():
        if shape.kind != "decode" or not cfg.supports_shape(shape)[0]:
            continue
        port = [(k, tuple(v.shape), 0) for k, v in
                flatten_named(TS.cache_specs(model, shape)).items()]
        ref = [(k, tuple(v.shape), _ref_batch_dim(v.shape)) for k, v in
               jax_flatten(JS.cache_specs(jm, J_SHAPES[key])).items()]
        for m in MESHES.values():
            sharded = shape.global_batch % D.dp_total(m) == 0
            for k, s, bd in port + ref:
                assert tuple(trules.cache_pspec(k, s, m, sharded, bd)) == \
                    tuple(jrules.cache_pspec(k, s, m, sharded, bd)), (k, s)
    E = cfg.moe.n_experts if cfg.moe else 0
    for m in MESHES.values():
        for sharded in (True, False):
            for T in (1, 16, 48, 256, 4096, 32 * 32768, 1000):
                with trules.activate(m, sharded), jrules.activate(m, sharded):
                    assert trules.dispatch_groups(T, E) == \
                        jrules.dispatch_groups(T, E), (T, E, sharded)
    assert trules.dispatch_groups(4096, E) == 1     # no context


def test_meshes_and_named_sharding():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == _Single.axis_names
    assert single.shape == _Single.shape and single.size == 256
    assert multi.axis_names == _Multi.axis_names
    assert multi.shape == _Multi.shape and multi.size == 512
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert make_host_mesh(model_parallel=4).shape == {"data": 1, "model": 1}
    spec = trules.P(("pod", "data"), None, "model")
    assert tuple(spec) == (("pod", "data"), None, "model")
    assert spec == jrules.P(("pod", "data"), None, "model")
    ns = trules.NamedSharding(multi, spec)
    assert ns.shard_shape((64, 3, 32)) == (2, 3, 2)
    assert ns.shard_bytes((64, 3, 32), torch.bfloat16) == 2 * 3 * 2 * 2
    with pytest.raises(ValueError, match="does not split"):
        ns.shard_shape((48, 3, 32))
    mesh = ShapeMesh(("data", "model"), (4, 2))
    with trules.activate(mesh) as ctx:
        x = torch.ones(4, 2)
        for kind in ("btd", "moe_buf", "grouped", "vmapped_buf",
                     "grouped_buf", "flat_tokens"):
            assert trules.constrain(x, kind) is x
        assert trules.current() is ctx
    assert trules.current() is None


HLO = """
HloModule test

ENTRY %main (p0: f32[64,128]) -> f32[64,128] {
  %p0 = f32[64,128]{1,0} parameter(0)
  %ag = f32[64,2048]{1,0} all-gather(f32[64,128]{1,0} %p0), replica_groups={}
  %ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p0), to_apply=%sum
  %rs = f32[4,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p0), dimensions={0}
  %cp = f32[64,128]{1,0} collective-permute(f32[64,128]{1,0} %p0)
  %a2a = f32[64,128]{1,0} all-to-all(f32[64,128]{1,0} %p0), dimensions={0}
  ROOT %out = f32[64,128]{1,0} add(%ar, %cp)
}
"""


def test_hlo_parser_matches_the_reference(forced_devices):
    from jax.sharding import PartitionSpec as JP
    assert thlo.parse_hlo_collectives(HLO) == \
        jhlo.parse_hlo_collectives(HLO)
    assert thlo.parse_hlo_collectives(HLO)["total"]["count"] == 5
    for t in ("f32[64,128]{1,0}", "bf16[8]", "(f32[2,2], bf16[4])", "pred[]"):
        assert thlo.shape_bytes(t) == jhlo.shape_bytes(t)
    mesh = jax.make_mesh((8,), ("x",))
    f = jax.jit(jax.shard_map(lambda a: jax.lax.psum(a, "x"), mesh=mesh,
                              in_specs=JP("x"), out_specs=JP()))
    text = f.lower(jax.ShapeDtypeStruct((64, 128), jnp.float32)) \
        .compile().as_text()
    got = thlo.parse_hlo_collectives(text)
    assert got == jhlo.parse_hlo_collectives(text)
    assert got["all-reduce"]["count"] >= 1
    log = [("all-reduce", 8, 8), ("all-gather", 4, 16),
           ("reduce-scatter", 16, 4), ("all-reduce", 2, 2)]
    rep = thlo.collective_report(log)
    assert rep["all-reduce"] == {"count": 2, "operand_bytes": 10,
                                 "result_bytes": 10}
    assert rep["total"] == {"count": 4, "operand_bytes": 30,
                            "result_bytes": 30}
    assert set(rep) == set(jhlo.parse_hlo_collectives(HLO))

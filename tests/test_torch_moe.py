"""The port's Mixture-of-Experts (``repro_torch.models.moe`` and the MoE
blocks of ``models.model``) against the JAX package's, on the CPU.

* ``expert_capacity`` equals the reference's exactly over a grid of token
  counts and capacity factors; ``MoEConfig``, ``reduced()`` and the
  ``mixtral-8x7b`` config equal the reference's field for field.
* ``router_topk`` gives the reference's experts on rows with exact ties
  (the lower expert first, as ``jax.lax.top_k``) and its weights.
* ``moe_forward``'s y, aux and gradients match the reference's on reduced
  ``mixtral-8x7b``, dropless and at ``capacity_factor`` 0.5, where
  capacity drops assignments (rtol 1e-5, atol 1e-6 of the largest value;
  the same f32 products in another summation order).
* Under ``sharding.rules.activate`` on a (4, 2) mesh the dispatch runs
  per data-shard group (G = 4, a capacity each) and matches the
  reference's grouped dispatch under its ``rules.activate`` on a real jax
  mesh: y, aux and gradients, at the same tolerance.
* ``dispatch_maps`` is a partial permutation, the reference's
  ``pos < cap`` rule, and its inverse; two runs are bit-identical.
* ``Model.loss`` and the whole trace of reduced ``mixtral-8x7b`` at S 128,
  where the window of 64 bites, pass the reference's ``compare_traces``
  against the JAX trace under the reference's f32 thresholds; so does a
  variant with a leading dense layer and a shared expert (the
  ``MoEConfig`` fields deepseek-v2 sets), whose parameter names are the
  reference's (``dense_layers.0.*``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (configs, jax_setup, one_thread,  # noqa: E402
                           to_jax_trace, torch_model)
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_plan as jax_build_plan  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs.base import PORT_MOE_FIELDS, get_config  # noqa: E402
from repro_torch.core.harness import make_model_runner  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import Model, build_plan  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

NAME = "mixtral-8x7b"
LONG_SEQ = 128          # twice the reduced window of 64
RTOL, ATOL = 1e-5, 1e-6


def setup_module():
    one_thread()


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = RTOL * np.abs(want) + ATOL * max(1.0, float(np.abs(want).max()))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


# ---------------------------------------------------------------------------
# configs and pure parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_mixtral_config_equals_the_reference(reduced):
    j, t = jax_get_config(NAME), get_config(NAME)
    if reduced:
        j, t = j.reduced(), t.reduced()
    # the port-only router fields sit at their defaults, the rest are equal
    tm = dataclasses.asdict(t.moe)
    assert {k: tm.pop(k) for k in PORT_MOE_FIELDS} == PORT_MOE_FIELDS
    assert tm == dataclasses.asdict(j.moe)
    for f in dataclasses.fields(t):
        if f.name not in ("moe", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("n_dense", [0, 1])
def test_build_plan_equals_the_reference(n_dense):
    j, t = jax_get_config(NAME), get_config(NAME)
    j = dataclasses.replace(j, n_layers=3, moe=dataclasses.replace(
        j.moe, n_dense_layers=n_dense))
    t = dataclasses.replace(t, n_layers=3, moe=dataclasses.replace(
        t.moe, n_dense_layers=n_dense))
    want = [(s.name, s.kind, s.n, s.layer0) for s in jax_build_plan(j)]
    assert [(s.name, s.kind, s.n, s.layer0) for s in build_plan(t)] == want


@pytest.mark.parametrize("factor", [0.0, -1.0, 0.25, 0.5, 1.0, 1.25, 2.0])
def test_expert_capacity_equals_the_reference(factor):
    for E, k in ((4, 2), (8, 2), (160, 6)):
        jm = dataclasses.replace(jax_get_config(NAME).moe, n_experts=E,
                                 top_k=k, capacity_factor=factor)
        tm = dataclasses.replace(get_config(NAME).moe, n_experts=E,
                                 top_k=k, capacity_factor=factor)
        for T in (1, 7, 16, 100, 128, 1000, 2047, 4096, 8192, 16384):
            assert tmoe.expert_capacity(T, tm) == jmoe.expert_capacity(T, jm)


def test_router_topk_breaks_exact_ties_as_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    logits[::2, 3] = logits[::2, 5]                  # a tie of two experts
    logits[1::4] = 0.25                              # every expert tied
    logits[3::8, 2] = logits[3::8, 6] = 4.0          # a tie at the top
    jp, je = jmoe.router_topk(jnp.asarray(logits), 2)
    tp, te = tmoe.router_topk(torch.tensor(logits), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tp.numpy(), np.asarray(jp), "top_p")


def _slots_reference(top_e, E, cap):
    """The reference's dispatch positions, in numpy: (expert, slot) of
    every kept assignment in assignment order."""
    flat = top_e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(se, np.arange(E))[se]
    out = {}
    for i, a in enumerate(order):
        if pos[i] < cap:
            out[int(a)] = (int(se[i]), int(pos[i]))
    return out


@pytest.mark.parametrize("cap", [3, 8, 64])
def test_dispatch_maps_are_the_reference_slots_and_inverse(cap):
    rng = np.random.default_rng(cap)
    E, T, k = 4, 32, 2
    top_e = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    slot, src, dropped = tmoe.dispatch_maps(torch.tensor(top_e)[None], E,
                                            cap)
    want = _slots_reference(top_e, E, cap)
    rows = E * cap
    got = {a: (int(s) // cap, int(s) % cap)
           for a, s in enumerate(slot.tolist()) if s != rows}
    assert got == want
    assert int(dropped[0]) == T * k - len(want)
    for a, s in enumerate(slot.tolist()):
        if s != rows:
            assert int(src[s]) == a
    assert sorted(int(a) for a in src if a != T * k) == sorted(want)


def test_expert_parallel_maps_keep_only_local_experts():
    rng = np.random.default_rng(0)
    E, T, k, cap = 4, 16, 2, 5
    top_e = torch.tensor(np.stack([rng.choice(E, k, replace=False)
                                   for _ in range(T)]))
    both = torch.stack([top_e, top_e])
    slot, src, _ = tmoe.dispatch_maps(both, E, cap,
                                      e0=torch.tensor([0, 2]), n_local=2)
    full_slot, _, _ = tmoe.dispatch_maps(top_e[None], E, cap)
    rows, N = 2 * 2 * cap, T * k
    for a in range(N):
        s = int(full_slot[a])
        kept = s != E * cap
        r = int(top_e.reshape(-1)[a]) // 2   # the rank owning its expert
        # kept on its expert's rank (at the same slot), on no other rank
        for rank in (0, 1):
            got = int(slot[rank * N + a])
            if kept and rank == r:
                assert got == rank * 2 * cap + s - r * 2 * cap
                assert int(src[got]) == rank * N + a
            else:
                assert got == rows


# ---------------------------------------------------------------------------
# moe_forward against the reference
# ---------------------------------------------------------------------------

def _moe_cfgs(factor):
    jcfg, tcfg = configs(NAME)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=factor)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=factor)))


@pytest.mark.parametrize("factor", [0.0, 0.5])
def test_moe_forward_matches_the_reference(factor):
    jcfg, tcfg = _moe_cfgs(factor)
    p = jax_setup(NAME)[2]["layers"][0]["mlp"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x, p):
        y, aux = jmoe.moe_forward(p, jcfg, x)
        return jnp.sum(y * g) + aux, (y, aux)
    (_, (jy, jaux)), (jgx, jgp) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)

    tp = {"router": torch.tensor(np.asarray(p["router"])),
          "experts": {n: torch.tensor(np.asarray(v))
                      for n, v in p["experts"].items()}}
    leaves = [tp["router"], *tp["experts"].values()]
    for t in leaves:
        t.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    ty, taux = tmoe.moe_forward(tp, tcfg, xt)
    (torch.sum(ty * torch.tensor(g)) + taux).backward()

    _close(ty.detach().numpy(), jy, "y")
    _close(taux.detach().numpy(), jaux, "aux")
    _close(xt.grad.numpy(), jgx, "dx")
    _close(tp["router"].grad.numpy(), jgp["router"], "drouter")
    for n in ("gate", "up", "down"):
        _close(tp["experts"][n].grad.numpy(), jgp["experts"][n], n)

    T = x.shape[0] * x.shape[1]
    logits = torch.tensor(x.reshape(T, -1)) @ tp["router"].detach()
    _, top_e = tmoe.router_topk(logits, tcfg.moe.top_k)
    cap = tmoe.expert_capacity(T, tcfg.moe)
    dropped = int(tmoe.dispatch_maps(top_e[None], tcfg.moe.n_experts,
                                     cap)[2][0])
    if factor > 0:
        assert dropped > 0, "capacity drops nothing: the keep mask is idle"
    else:
        assert dropped == 0


def test_grouped_dispatch_matches_the_reference(forced_devices):
    """Under ``rules.activate`` on a (4, 2) ("data", "model") mesh both
    packages split the 64 tokens into G = 4 dispatch groups of 16, each
    with its own capacity (4 at factor 0.5, against 16 for one group), so
    other assignments drop; y, aux and every gradient match the
    reference's, and y differs from the one-group dispatch."""
    from repro.sharding import rules as jrules
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.sharding import rules as trules
    jcfg, tcfg = _moe_cfgs(0.5)
    p = jax_setup(NAME)[2]["layers"][0]["mlp"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    auto = jax.sharding.AxisType.Auto        # with_sharding_constraint's
    jmesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(auto, auto))
    tmesh = ShapeMesh(("data", "model"), (4, 2))

    def jf(x, p):
        y, aux = jmoe.moe_forward(p, jcfg, x)
        return jnp.sum(y * g) + aux, (y, aux)
    with jrules.activate(jmesh):
        assert jrules.dispatch_groups(64, 4) == 4
        (_, (jy, jaux)), (jgx, jgp) = jax.jit(jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True))(jnp.asarray(x), p)

    def port(grouped):
        tp = {"router": torch.tensor(np.asarray(p["router"])),
              "experts": {n: torch.tensor(np.asarray(v))
                          for n, v in p["experts"].items()}}
        for t in [tp["router"], *tp["experts"].values()]:
            t.requires_grad_()
        xt = torch.tensor(x, requires_grad=True)
        if grouped:
            with trules.activate(tmesh):
                assert trules.dispatch_groups(64, 4) == 4
                ty, taux = tmoe.moe_forward(tp, tcfg, xt)
        else:
            ty, taux = tmoe.moe_forward(tp, tcfg, xt)
        (torch.sum(ty * torch.tensor(g)) + taux).backward()
        return ty, taux, xt, tp

    ty, taux, xt, tp = port(True)
    _close(ty.detach().numpy(), jy, "y")
    _close(taux.detach().numpy(), jaux, "aux")
    _close(xt.grad.numpy(), jgx, "dx")
    _close(tp["router"].grad.numpy(), jgp["router"], "drouter")
    for n in ("gate", "up", "down"):
        _close(tp["experts"][n].grad.numpy(), jgp["experts"][n], n)
    one = port(False)[0]
    assert (one - ty).abs().max() > 1e-3, "grouping dropped nothing new"


def test_two_runs_are_bit_identical():
    _, tcfg = _moe_cfgs(0.5)
    model = torch_model(NAME)
    mlp = model.layers[0].mlp
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32))
    mlp.cfg = tcfg
    outs = []
    for _ in range(2):
        mlp.zero_grad()
        y, aux = mlp(x)
        (y.square().sum() + aux).backward()
        outs.append([y.detach().clone(), aux.detach().clone()]
                    + [p.grad.clone() for p in mlp.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the whole model: loss and trace against the reference
# ---------------------------------------------------------------------------

def test_model_parameters_are_the_reference_names():
    named = jax_setup(NAME)[3]
    model = torch_model(NAME)
    assert set(dict(model.named_parameters())) == set(named)
    assert model.layers[0].mlp.router.dtype == torch.float32
    assert "layers.0.mlp.router" in named


def test_model_loss_matches_the_reference():
    jcfg, jm, params, named, batch = jax_setup(NAME, seq=LONG_SEQ)
    jloss, jmet = jm.loss(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    model = torch_model(NAME, named)
    with torch.no_grad():
        tloss, tmet = model.loss({k: torch.tensor(v)
                                  for k, v in batch.items()})
    assert float(jmet["aux"]) > 0
    _close(float(tmet["aux"]), float(jmet["aux"]), "aux")
    _close(float(tloss), float(jloss), "loss")


def _dense_first_shared(cfg):
    """A deepseek-style MoE arch: a leading dense layer of d_ff_dense and
    one shared expert (the reduced sizes of ``reduced()``)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_dense_layers=1, n_shared=1, d_ff_dense=256))


def test_dense_first_layer_and_shared_expert_match_the_reference():
    """Parameter names (``dense_layers.0.*`` beside ``layers.0.*``, the
    shared expert's ``shared.{gate,up,down}.w``) and the whole trace at
    S 128 against the reference's, under its f32 thresholds."""
    from repro.core.collector import flatten_named
    from repro.data.synthetic import make_batch
    from repro.models.model import Model as JaxModel
    from repro_torch.interop import params_from_jax
    jcfg, tcfg = (_dense_first_shared(c) for c in configs(NAME))
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v) for k, v in make_batch(jcfg, 2, LONG_SEQ)
             .items()}
    model = params_from_jax(named, Model(tcfg, device="cpu"))
    assert "dense_layers.0.mlp.gate.w" in named
    assert "layers.0.mlp.shared.down.w" in named
    opt = JaxAdamW(lr=1e-3)
    thr, jtrace = estimate_thresholds(
        jax_runner(jm, params, opt, opt.init(params)), batch,
        MACHINE_EPS["float32"])
    port = to_jax_trace(make_model_runner(model, AdamW(lr=1e-3),
                                          device="cpu")(batch))
    rep = compare_traces(jtrace, port, thr)
    assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jtrace.meta["fwd_order"]
    assert "layers.1.mlp/router_logits" in port.meta["fwd_order"]


def test_trace_passes_the_reference_checker():
    """S 128 against a window of 64: the sliding window bites."""
    jcfg, jm, params, named, batch = jax_setup(NAME, seq=LONG_SEQ)
    opt = JaxAdamW(lr=1e-3)
    run = jax_runner(jm, params, opt, opt.init(params))
    thr, jtrace = estimate_thresholds(run, batch, MACHINE_EPS["float32"])
    model = torch_model(NAME, named)
    port = to_jax_trace(make_model_runner(model, AdamW(lr=1e-3),
                                          device="cpu")(batch))
    rep = compare_traces(jtrace, port, thr)
    worst = max(r.rel_err / r.threshold for r in rep.records)
    print(f"reduced {NAME} at S {LONG_SEQ}: {len(rep.records)} tensors, "
          f"worst rel_err/threshold {worst:.3g}")
    assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jtrace.meta["fwd_order"]
    assert "layers.0.mlp/router_logits" in port.meta["fwd_order"]
    assert len(rep.records) == sum(
        len(getattr(jtrace, s)) for s in
        ("activations", "act_grads", "param_grads", "main_grads",
         "params_post"))

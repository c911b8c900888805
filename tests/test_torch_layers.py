"""Port vs reference: layers, attention, configs, canonical ids and the
consistent generator (f32, atol 1e-5 unless stated)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import CONFIGS, configs, jax_setup, one_thread, torch_model  # noqa: E402
from repro.core import canonical as JC, generator as JG  # noqa: E402
from repro.models import attention as JA, layers as JL  # noqa: E402
from repro_torch.core import canonical as TC, generator as TG  # noqa: E402
from repro_torch.core.collector import named_params  # noqa: E402
from repro_torch.models import attention as TA, layers as TL  # noqa: E402

ATOL = 1e-5


def setup_module():
    one_thread()


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def test_rmsnorm_matches_jax():
    x, w = _rand(2, 5, 32, seed=1, scale=3.0), _rand(32, seed=2)
    _close(TL.rmsnorm(torch.from_numpy(w), torch.from_numpy(x)),
           JL.rmsnorm(jnp.asarray(w), jnp.asarray(x)))


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (2, 7, 16)])
def test_apply_rope_matches_jax(shape):
    x = _rand(*shape, seed=3)
    pos = np.broadcast_to(np.arange(shape[1]), shape[:2]).copy()
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


def test_swiglu_mlp_matches_jax():
    gen = torch.Generator().manual_seed(0)
    mlp = TL.SwiGLUMLP(gen, 32, 64, torch.float32)
    x = _rand(2, 5, 32, seed=4)
    p = {k: {"w": jnp.asarray(getattr(mlp, k).w.detach().numpy())}
         for k in ("gate", "up", "down")}
    _close(mlp(torch.from_numpy(x)), JL.swiglu_mlp(p, jnp.asarray(x)))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    logits = _rand(2, 6, 40, seed=5, scale=4.0)
    labels = np.random.default_rng(6).integers(0, 40, (2, 6))
    mask = (np.arange(6)[None] < np.array([[4], [6]])) if masked else None
    t = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    j = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask))
    _close(t, j)


@pytest.mark.parametrize("mode", ["causal", "swa", "bidirectional"])
def test_attention_ref_matches_jax_gqa(mode):
    q, k, v = (_rand(2, 24, 4, 16, seed=7), _rand(2, 24, 2, 16, seed=8),
               _rand(2, 24, 2, 16, seed=9))
    t = TA.attention_ref(*map(torch.from_numpy, (q, k, v)), mode=mode,
                         window=5)
    j = JA.attention_ref(*map(jnp.asarray, (q, k, v)), mode=mode, window=5)
    _close(t, j)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_copy_matches_reference(name):
    jcfg, tcfg = configs(name)
    for full in (False, True):
        j = jax_get(name) if full else jcfg
        t = torch_get(name) if full else tcfg
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def jax_get(name):
    from repro.configs.base import get_config
    return get_config(name)


def torch_get(name):
    from repro_torch.configs.base import get_config
    return get_config(name)


@pytest.mark.parametrize("name", CONFIGS)
def test_model_parameter_names_match_flatten_named(name):
    named = jax_setup(name)[3]
    tm = torch_model(name, named)
    assert list(named_params(tm)) == list(named)
    for k, p in named_params(tm).items():
        assert tuple(p.shape) == named[k].shape, k


def test_canonical_ids_and_generator_are_bit_identical():
    names = ["layers.3.mlp/input", "embedding/output", "final_norm_out"]
    for n in names:
        assert (TC.tap_to_id(n, TC.KIND_ACT).seed()
                == JC.tap_to_id(n, JC.KIND_ACT).seed())
        t = TG.generate(TC.tap_to_id(n, TC.KIND_ACT), (3, 5, 7), scale=0.3)
        j = JG.generate(JC.tap_to_id(n, JC.KIND_ACT), (3, 5, 7), scale=0.3)
        assert np.array_equal(t, j)
    x = _rand(4, 33, seed=10)
    assert np.array_equal(TG.perturb(x, 2.0 ** -8, seed=3),
                          JG.perturb(x, 2.0 ** -8, seed=3))

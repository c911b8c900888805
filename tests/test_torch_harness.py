"""The port's ``ttrace_check`` against the reference harness on the CPU: the
same verdict on a clean candidate, and on a candidate with one perturbed
MLP weight the same verdict and the same localized module."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CONFIGS, jax_setup, one_thread, torch_model  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner, \
    ttrace_check as jax_check  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

BAD = "layers.1.mlp.down.w"


def setup_module():
    one_thread()


def _perturbed(named):
    bad = dict(named)
    bad[BAD] = (named[BAD] * np.float32(1.01)).astype(named[BAD].dtype)
    return bad


def _jax_params(template, named):
    from repro.core.collector import unflatten_named
    return unflatten_named({k: jax.numpy.asarray(v) for k, v in named.items()},
                           template)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("buggy", [False, True], ids=["clean", "perturbed"])
def test_port_harness_matches_reference_verdict(name, buggy):
    # no optimizer on either side (the reference harness test's set-up);
    # test_torch_collector holds the optimizer's sections to the reference
    _, jm, params, named, batch = jax_setup(name)
    cand_named = _perturbed(named) if buggy else named
    jres = jax_check(jax_runner(jm, params),
                     jax_runner(jm, _jax_params(params, cand_named)), batch)
    tres = ttrace_check(
        make_model_runner(torch_model(name, named), device="cpu"),
        make_model_runner(torch_model(name, cand_named), device="cpu"),
        batch)
    assert tres.passed == jres.passed == (not buggy)
    if buggy:
        assert tres.localization is not None
        assert tres.localized_module == jres.localized_module == "layers.1.mlp"
    else:
        assert tres.localization is None


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from _torch_parity import configs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(configs("gpt-paper")[1])

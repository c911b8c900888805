"""A port trace of one training step, judged by the reference's checker.

The reference's ``compare_traces``, with thresholds from the reference's
``estimate_thresholds`` at f32 eps, must PASS on the port's five-section
trace, with the same section names and forward order and nothing missing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import CONFIGS, jax_setup, one_thread, to_jax_trace, torch_model  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.core.collector import SECTION_FIELDS, trace_train_step  # noqa: E402
from repro_torch.core.tap import TraceContext  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402



def setup_module():
    one_thread()


@pytest.mark.parametrize("name", CONFIGS)
def test_port_trace_passes_reference_checker(name):
    _, jm, params, named, batch = jax_setup(name)
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch,
        MACHINE_EPS["float32"])
    tr, _, _ = trace_train_step(
        torch_model(name, named), {k: torch.from_numpy(v) for k, v in batch.items()},
        opt=AdamW(lr=1e-3))
    port = to_jax_trace(tr)
    for sec in SECTION_FIELDS:
        assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
        assert len(getattr(port, sec)) > 0, sec
    assert port.meta["fwd_order"] == jref.meta["fwd_order"]
    rep = jax_compare(jref, port, thr)
    assert rep.passed, rep.summary()
    assert not rep.missing
    assert len(rep.records) == sum(len(getattr(jref, s)) for s in SECTION_FIELDS)
    # the tied embedding's gradient sums the gather's and the logits' parts
    emb = "embedding.word_embeddings"
    np.testing.assert_allclose(port.param_grads[emb], jref.param_grads[emb],
                               rtol=0, atol=1e-6)
    assert port.loss == pytest.approx(jref.loss, rel=1e-6)
    assert port.grad_norm == pytest.approx(jref.grad_norm, rel=1e-5)


def test_tap_rewrite_is_straight_through_and_probes_give_gradients():
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    ctx = TraceContext("rewrite", rewrites={"m/input": np.array([5.0, 5.0, 5.0])},
                       probes=True)
    with ctx.scope("m"):
        y = ctx.tap("input", x)
    (3.0 * y).sum().backward()
    assert torch.equal(ctx.fwd["m/input"], torch.full((3,), 5.0))
    assert torch.equal(x.grad, torch.full((3,), 3.0))
    assert torch.equal(ctx.probes["m/input"].grad, torch.full((3,), 3.0))
    with pytest.raises(ValueError, match="duplicate"):
        with ctx.scope("m"):
            ctx.tap("input", x)
    off = TraceContext("off")
    assert off.tap("input", x) is x and not off.fwd

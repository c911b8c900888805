"""The port's trace at the dtypes the card runs, judged by the reference.

Every other parity test takes ``.reduced()`` configs, and ``reduced()``
forces f32 compute and params.  Here each config keeps its full config's
``compute_dtype`` and ``param_dtype`` (bf16 compute; f32 params for
``gpt-paper``, bf16 for ``tinyllama-1.1b`` and ``rwkv6-7b``), on both
sides, reduced to ``n_layers=2, vocab=256``.  The reference's
``compare_traces``, under thresholds from the reference's
``estimate_thresholds`` at bf16 eps, must PASS the port's one-step trace
against the JAX trace: B 2 x S 16, S 64 for ``rwkv6-7b`` (two chunks of its
reduced chunk of 32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import BATCH, RWKV, RWKV_SEQ, SEQ, one_thread, to_jax_trace  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs.base import get_config as torch_get_config  # noqa: E402
from repro_torch.core.collector import SECTION_FIELDS, trace_train_step  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models.model import Model as TorchModel  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

CASES = [("gpt-paper", SEQ), ("tinyllama-1.1b", SEQ), (RWKV, RWKV_SEQ)]


def setup_module():
    one_thread()


def card_dtypes(get_config, name):
    """``name`` reduced to 2 layers and vocab 256, at its full dtypes."""
    full = get_config(name)
    return dataclasses.replace(full.reduced(), n_layers=2, vocab=256,
                               compute_dtype=full.compute_dtype,
                               param_dtype=full.param_dtype)


@pytest.mark.parametrize("name,seq", CASES, ids=[c[0] for c in CASES])
def test_port_trace_at_card_dtypes_passes_reference_checker(name, seq):
    jcfg = card_dtypes(jax_get_config, name)
    tcfg = card_dtypes(torch_get_config, name)
    assert tcfg.compute_dtype == jcfg.compute_dtype == "bfloat16"
    assert tcfg.param_dtype == jcfg.param_dtype
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v)
             for k, v in jax_make_batch(jcfg, BATCH, seq).items()}
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch,
        MACHINE_EPS["bfloat16"])

    model = params_from_jax(named, TorchModel(tcfg, device="cpu"))
    dtypes = {p.dtype for p in model.parameters()}
    assert getattr(torch, tcfg.param_dtype) in dtypes, dtypes
    tr, _, _ = trace_train_step(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        opt=AdamW(lr=1e-3))
    port = to_jax_trace(tr)
    for sec in SECTION_FIELDS:
        assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
    rep = jax_compare(jref, port, thr)
    assert rep.passed and not rep.missing, rep.summary()
    worst = max(r.rel_err / r.threshold for r in rep.records)
    assert worst < 1.0

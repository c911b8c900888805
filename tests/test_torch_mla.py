"""The port's Multi-head Latent Attention (``repro_torch.models.attention.
MLAttention`` and the MLA blocks of ``models.model``) against the JAX
package's, on the CPU.

* ``MLAConfig``, ``reduced()`` and the ``deepseek-v2-236b`` config equal
  the reference's field for field; ``build_plan`` gives its segments.
* ``MLAttention`` has ``mla_init``'s parameter names, and its forward and
  every gradient match ``mla_forward``'s within rtol 1e-5 at f32, with
  the full-rank q (``q_lora_rank`` 0, the reduced config's) and with the
  q LoRA (``q_lora_rank`` 32, the branch the full config takes).
* ``attention_blockwise`` with D 48 != Dv 32 (MLA's shape of the problem)
  matches the reference's at small blocks, forward and gradients.
* The whole reduced ``deepseek-v2-236b`` (MLA, a dense layer 0, an MoE
  layer with a shared expert) passes the reference's ``compare_traces``
  against the JAX trace under the JAX f32 thresholds; with
  ``dense_layers.0.self_attention.linear_uk.w`` doubled the port's
  harness gives the reference harness's verdict and module.  While it
  localizes, every section of the check's two traces but the reference's
  activations waits on the host; the result's traces come back whole, on
  the runners' device.
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
from repro.core.collector import flatten_named, unflatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_plan as jax_build_plan  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs.base import PORT_MOE_FIELDS, get_config  # noqa: E402
from repro_torch.core import harness  # noqa: E402
from repro_torch.core.collector import SECTION_FIELDS  # noqa: E402
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build_plan  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

NAME = "deepseek-v2-236b"
RTOL, ATOL = 1e-5, 1e-6
BAD = "dense_layers.0.self_attention.linear_uk.w"


def setup_module():
    one_thread()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol * max(1.0, float(np.abs(want).max()))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_deepseek_config_equals_the_reference(reduced):
    j, t = jax_get_config(NAME), get_config(NAME)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert dataclasses.asdict(t.mla) == dataclasses.asdict(j.mla)
    # the port-only router fields sit at their defaults, the rest are equal
    tm = dataclasses.asdict(t.moe)
    assert {k: tm.pop(k) for k in PORT_MOE_FIELDS} == PORT_MOE_FIELDS
    assert tm == dataclasses.asdict(j.moe)
    for f in dataclasses.fields(t):
        if f.name not in ("moe", "mla", "ssm"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.is_decoder == j.is_decoder
    want = [(s.name, s.kind, s.n, s.layer0) for s in jax_build_plan(j)]
    assert [(s.name, s.kind, s.n, s.layer0) for s in build_plan(t)] == want


# ---------------------------------------------------------------------------
# MLAttention against mla_forward
# ---------------------------------------------------------------------------

def _mla_cfgs(q_lora):
    jcfg, tcfg = configs(NAME)
    return tuple(dataclasses.replace(c, mla=dataclasses.replace(
        c.mla, q_lora_rank=q_lora)) for c in (jcfg, tcfg))


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_forward_and_gradients_match_the_reference(q_lora):
    jcfg, tcfg = _mla_cfgs(q_lora)
    p = jattn.mla_init(jax.random.PRNGKey(5), jcfg, jnp.float32, 0.01)
    named = {k: np.asarray(v) for k, v in flatten_named(p).items()}
    mod = params_from_jax(named, tattn.MLAttention(
        torch.Generator().manual_seed(0), tcfg, torch.float32))
    assert ("linear_uq.w" in named) == bool(q_lora)
    assert ("linear_q.w" in named) != bool(q_lora)

    rng = np.random.default_rng(11 + q_lora)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)

    def jf(x, p):
        y = jattn.mla_forward(p, jcfg, x)
        return jnp.sum(y * g), y
    (_, jy), (jgx, jgp) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(jnp.asarray(x), p)
    xt = torch.tensor(x, requires_grad=True)
    ty = mod(xt)
    torch.sum(ty * torch.tensor(g)).backward()
    _close(ty.detach().numpy(), jy, "y")
    _close(xt.grad.numpy(), jgx, "dx")
    jgrads = flatten_named(jgp)
    for name, prm in mod.named_parameters():
        _close(prm.grad.numpy(), jgrads[name], name)


def test_mla_refuses_the_flash_kernel():
    _, tcfg = _mla_cfgs(0)
    mod = tattn.MLAttention(torch.Generator().manual_seed(0), tcfg,
                            torch.float32)
    with pytest.raises(ValueError, match="no flash-kernel path"):
        mod(torch.zeros(1, 4, tcfg.d_model), use_kernel=True)


@pytest.mark.parametrize("mode", ["causal", "bidirectional"])
def test_blockwise_with_narrower_values_matches_the_reference(mode):
    B, S, H, D, Dv, blk = 2, 32, 3, 48, 32, 8
    rng = np.random.default_rng(2)
    q, k = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    g = rng.standard_normal((B, S, H, Dv)).astype(np.float32)

    def jf(q, k, v):
        o = jattn.attention_blockwise(q, k, v, mode=mode, q_block=blk,
                                      kv_block=blk)
        return jnp.sum(o * g), o
    (_, jo), jgr = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    to = tattn.attention_blockwise(*ts, mode=mode, q_block=blk, kv_block=blk)
    assert to.shape == (B, S, H, Dv)
    torch.sum(to * torch.tensor(g)).backward()
    _close(to.detach().numpy(), jo, "o")
    for t, jg, n in zip(ts, jgr, "qkv"):
        _close(t.grad.numpy(), jg, f"d{n}")


# ---------------------------------------------------------------------------
# the whole reduced deepseek-v2-236b
# ---------------------------------------------------------------------------

def test_model_parameters_are_the_reference_names():
    named = jax_setup(NAME)[3]
    model = torch_model(NAME)
    assert set(dict(model.named_parameters())) == set(named)
    assert BAD in named and "layers.0.mlp.shared.down.w" in named
    assert "dense_layers.0.self_attention.kv_lora_norm" in named


def test_trace_passes_the_reference_checker():
    jcfg, jm, params, named, batch = jax_setup(NAME)
    opt = JaxAdamW(lr=1e-3)
    thr, jtrace = estimate_thresholds(jax_runner(jm, params, opt,
                                                 opt.init(params)),
                                      batch, MACHINE_EPS["float32"])
    port = to_jax_trace(make_model_runner(torch_model(NAME, named),
                                          AdamW(lr=1e-3), device="cpu")(batch))
    rep = compare_traces(jtrace, port, thr)
    worst = max(r.rel_err / r.threshold for r in rep.records)
    print(f"reduced {NAME}: {len(rep.records)} tensors, worst "
          f"rel_err/threshold {worst:.3g}")
    assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jtrace.meta["fwd_order"]
    for name in ("layers.0.self_attention/core_attn_out",
                 "layers.1.mlp/router_logits"):
        assert name in port.meta["fwd_order"]


def test_doubled_uk_weight_matches_reference_verdict():
    _, jm, params, named, batch = jax_setup(NAME)
    bad = dict(named)
    bad[BAD] = named[BAD] * np.float32(2.0)
    jbad = unflatten_named({k: jnp.asarray(v) for k, v in bad.items()},
                           params)
    jopt = JaxAdamW(lr=1e-3)
    jres = jax_check(jax_runner(jm, params, jopt, jopt.init(params)),
                     jax_runner(jm, jbad, jopt, jopt.init(jbad)), batch)
    opt = AdamW(lr=1e-3)
    tres = ttrace_check(
        make_model_runner(torch_model(NAME, named), opt, device="cpu"),
        make_model_runner(torch_model(NAME, bad), opt, device="cpu"), batch)
    assert not tres.passed and not jres.passed
    assert tres.localized_module == jres.localized_module
    assert tres.localized_module.startswith("layers.0.self_attention")


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_localization_leaves_the_traces_whole(device, monkeypatch):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: moves trace leaves off the card")
    _, _, _, named, batch = jax_setup(NAME)
    bad = dict(named)
    bad[BAD] = named[BAD] * np.float32(2.0)
    opt = AdamW(lr=1e-3)
    ref, cand = (make_model_runner(torch_model(NAME, p).to(device), opt,
                                   device=device) for p in (named, bad))
    runs = []

    def cand_kept(b, rewrites=None):
        runs.append(cand(b, rewrites))
        return runs[-1]

    snap = {}
    real = harness.localize_with_rewrites

    def spy(run_ref, run_cand, b, ref_trace, thr):
        for side, tr in (("ref", ref_trace), ("cand", runs[0])):
            for f in SECTION_FIELDS:
                for n, x in getattr(tr, f).raw_items():
                    kept = side == "ref" and f == "activations"
                    assert x.device.type == (device if kept else "cpu"), \
                        (side, f, n)
                    snap[side, f, n] = x.clone()
        return real(run_ref, run_cand, b, ref_trace, thr)

    monkeypatch.setattr(harness, "localize_with_rewrites", spy)
    res = ttrace_check(ref, cand_kept, batch)
    assert not res.passed and res.localization is not None
    assert res.candidate is runs[0] and len(runs) == 2
    got = {(side, f, n): x
           for side, tr in (("ref", res.reference), ("cand", res.candidate))
           for f in SECTION_FIELDS for n, x in getattr(tr, f).raw_items()}
    assert list(got) == list(snap)
    for key, x in got.items():
        assert x.device.type == device, key
        assert torch.equal(x.cpu(), snap[key].cpu()), key


def test_distributed_candidate_refuses_mla():
    """The reference's distributed block is ``tp_gqa_attention`` only; the
    port's runs MLA with its heads over tp (``tp_mla_attention``) and
    refuses it under context parallelism instead of failing inside the
    candidate."""
    from repro_torch.parallel.api import ParallelConfig, make_candidate_runner
    _, tcfg = configs(NAME)
    with pytest.raises(ValueError, match="no context-parallel MLA"):
        make_candidate_runner(tcfg, ParallelConfig(cp=2), torch_model(NAME),
                              device="cpu")
    assert callable(make_candidate_runner(tcfg, ParallelConfig(tp=2),
                                          torch_model(NAME), device="cpu"))

"""The port's configuration system and the configs of the remaining dense
options and frontends (``qk_norm``, ``qkv_bias``, the VLM and the audio
encoder) against the JAX package, on the CPU.  Parameters and batches
come from the reference and cross as numpy; on the CPU the port takes its
plain versions.

* For every config of the reference, the port's ``ArchConfig`` equals the
  reference's on every field of the reference's (``scan_layers``,
  ``remat`` and ``remat_policy`` included), full and ``.reduced()``, and
  each port-only ``MoEConfig`` field (``PORT_MOE_FIELDS``) sits at its
  default there; the port's ``list_configs()`` is the reference's eleven
  names and one port-only name, ``moonlight-16b-a3b``; both give the
  same ``INPUT_SHAPES``, ``is_decoder`` and ``supports_shape`` over the
  11 x 4 (config, shape) pairs.
* The five configs ``DENSE_OPTIONS``, reduced: ``named_parameters()`` is
  ``flatten_named``'s names in its order, and the AdamW decay mask is the
  reference's; under the reference's f32 thresholds its ``compare_traces``
  passes the port's plain trace and its flash candidate's trace
  (``chip_smoke.flash_runner``), with the same records and ``fwd_order``.
* Six controls get the reference harness's verdict and module.  A bias
  control shifts the bias by 0.1: biases start at zero, so doubling one
  changes nothing.  Under bf16 eps the doubled ``mask_embed`` moves the
  embedding output under its threshold's 12.5% floor, and both packages
  FAIL at the same module past the embedding (the verdict the card gives
  at full width).
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (DENSE_OPTIONS, configs, jax_setup,  # noqa: E402
                           one_thread, to_jax_trace, torch_model)
from repro.configs import base as jbase  # noqa: E402
from repro.core.checker import compare_traces as jax_compare  # noqa: E402
from repro.core.collector import unflatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.harness import ttrace_check as jax_check  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.collector import (SECTION_FIELDS, named_params,  # noqa: E402
                                        trace_train_step)
from repro_torch.core.harness import make_model_runner, ttrace_check  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ALL = tuple(jbase.list_configs())
# (config, parameter, how it is broken, the module the check must name)
CONTROLS = (
    ("qwen3-32b", "layers.1.self_attention.q_norm", "x2",
     "layers.1.self_attention"),
    ("codeqwen1.5-7b", "layers.1.self_attention.linear_qkv.b", "+0.1",
     "layers.1.self_attention"),
    ("llava-next-34b", "vision_proj.w", "x2", "embedding"),
    ("hubert-xlarge", "layers.1.mlp.fc2.w", "x2", "layers.1.mlp"),
    ("hubert-xlarge", "mask_embed", "x2", "embedding"),
    ("hubert-xlarge", "audio_proj.b", "+0.1", "embedding"),
)


def setup_module():
    one_thread()


def _value(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# ---------------------------------------------------------------------------
# the configuration system
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_config_equals_the_reference(name, reduced):
    j, t = jbase.get_config(name), tbase.get_config(name)
    if reduced:
        j, t = j.reduced(), t.reduced()
    fields = {f.name for f in dataclasses.fields(t)}
    assert fields == {f.name for f in dataclasses.fields(j)}
    for f in sorted(fields):
        tv = _value(getattr(t, f))
        if f == "moe" and tv is not None:
            assert {k: tv.pop(k) for k in tbase.PORT_MOE_FIELDS} \
                == tbase.PORT_MOE_FIELDS
        assert tv == _value(getattr(j, f)), f


def test_registry_and_input_shapes_are_the_reference_ones():
    assert jbase.list_configs() == sorted(ALL)
    assert tbase.list_configs() == sorted(ALL + ("moonlight-16b-a3b",))
    assert len(ALL) == 11
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("qwen3-33b")


@pytest.mark.parametrize("name", ALL)
def test_is_decoder_and_supports_shape_are_the_reference_ones(name):
    j, t = jbase.get_config(name), tbase.get_config(name)
    assert t.is_decoder == j.is_decoder
    assert t.is_decoder == (name != "hubert-xlarge")
    for key, shape in tbase.INPUT_SHAPES.items():
        assert t.supports_shape(shape) == j.supports_shape(
            jbase.INPUT_SHAPES[key]), key


# ---------------------------------------------------------------------------
# the five configs, reduced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE_OPTIONS)
def test_names_order_and_decay_mask_are_the_reference_ones(name):
    import jax
    _, _, params, named, _ = jax_setup(name)
    model = torch_model(name, named)
    assert list(named_params(model)) == list(named)
    mask = dict(zip(named, jax.tree.leaves(JaxAdamW()._decay_mask(params))))
    assert {k: AdamW().decays(k) for k in named} == \
        {k: bool(v) for k, v in mask.items()}
    new = {"qwen3-32b": {"layers.0.self_attention.q_norm",
                         "layers.0.self_attention.k_norm"},
           "codeqwen1.5-7b": {"layers.0.self_attention.linear_qkv.b"},
           "qwen1.5-110b": {"layers.0.self_attention.linear_qkv.b"},
           "llava-next-34b": {"vision_proj.w", "vision_proj.b"},
           "hubert-xlarge": {"audio_proj.w", "audio_proj.b", "mask_embed",
                             "layers.0.mlp.fc1.b", "layers.0.mlp.fc2.w",
                             "embedding.word_embeddings"}}[name]
    assert new <= set(named)


@pytest.mark.parametrize("name", DENSE_OPTIONS)
def test_port_traces_pass_reference_checker(name):
    _, jm, params, named, batch = jax_setup(name)
    jopt = JaxAdamW(lr=1e-3)
    thr, jref = estimate_thresholds(
        jax_runner(jm, params, jopt, jopt.init(params)), batch,
        MACHINE_EPS["float32"])
    model = torch_model(name, named)
    plain, _, _ = trace_train_step(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        opt=AdamW(lr=1e-3))
    flash = chip_smoke.flash_runner(model, AdamW(lr=1e-3))(batch)
    for tr in (plain, flash):
        port = to_jax_trace(tr)
        for sec in SECTION_FIELDS:
            assert list(getattr(port, sec)) == list(getattr(jref, sec)), sec
        assert port.meta["fwd_order"] == jref.meta["fwd_order"]
        rep = jax_compare(jref, port, thr)
        assert rep.passed and not rep.missing, rep.summary()
        assert port.loss == pytest.approx(jref.loss, rel=1e-5)


@pytest.mark.parametrize("name,bad_name,how,module", CONTROLS,
                         ids=[f"{c[0]}:{c[1]}" for c in CONTROLS])
def test_controls_match_reference_verdict(name, bad_name, how, module):
    _, jm, params, named, batch = jax_setup(name)
    bad = dict(named)
    bad[bad_name] = (named[bad_name] * np.float32(2.0) if how == "x2"
                     else named[bad_name] + np.float32(0.1))
    jbad = unflatten_named({k: jnp.asarray(v) for k, v in bad.items()},
                           params)
    jopt = JaxAdamW(lr=1e-3)
    jres = jax_check(jax_runner(jm, params, jopt, jopt.init(params)),
                     jax_runner(jm, jbad, jopt, jopt.init(jbad)), batch)
    opt = AdamW(lr=1e-3)
    tres = ttrace_check(
        make_model_runner(torch_model(name, named), opt, device="cpu"),
        make_model_runner(torch_model(name, bad), opt, device="cpu"), batch)
    assert not tres.passed and not jres.passed
    assert tres.localized_module == jres.localized_module == module


def test_mask_embed_control_under_bf16_eps_matches_the_reference():
    name, bad_name = "hubert-xlarge", "mask_embed"
    _, jm, params, named, batch = jax_setup(name)
    bad = dict(named, **{bad_name: named[bad_name] * np.float32(2.0)})
    jbad = unflatten_named({k: jnp.asarray(v) for k, v in bad.items()},
                           params)
    jopt, opt = JaxAdamW(lr=1e-3), AdamW(lr=1e-3)
    eps = MACHINE_EPS["bfloat16"]
    jres = jax_check(jax_runner(jm, params, jopt, jopt.init(params)),
                     jax_runner(jm, jbad, jopt, jopt.init(jbad)), batch,
                     eps=eps)
    tres = ttrace_check(
        make_model_runner(torch_model(name, named), opt, device="cpu"),
        make_model_runner(torch_model(name, bad), opt, device="cpu"), batch,
        eps=eps)
    assert not tres.passed and not jres.passed
    assert tres.localized_module == jres.localized_module != "embedding"
    for res in (tres, jres):
        emb, = [r for r in res.report.records
                if (r.kind, r.name) == ("activation", "embedding/output")]
        assert not emb.flagged and emb.rel_err > 0.01


def test_frontend_batches_have_the_reference_layout():
    from repro_torch.data.synthetic import make_batch
    for name in ("llava-next-34b", "hubert-xlarge"):
        _, tcfg = configs(name)
        want = jax_setup(name)[4]
        got = make_batch(tcfg, 2, 64 if name == "llava-next-34b" else 16,
                         device="cpu")
        assert list(got) == list(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape, k
            assert v.is_floating_point() == (want[k].dtype.kind == "f"), k
            assert (v.dtype == torch.bool) == (want[k].dtype == bool), k
    # full width: llava keeps all 2880 image tokens of a 4096 sequence
    b = make_batch(tbase.get_config("llava-next-34b"), 1, 4096, device="cpu")
    assert b["image_embeds"].shape == (1, 2880, 1024)
    assert b["tokens"].shape == b["labels"].shape == (1, 1216)

"""The remaining dense options (``qk_norm``, ``qkv_bias``, the GELU MLP, the
audio encoder's rope-free bidirectional attention) and their paths beyond
the single-device check, against the JAX package on the CPU.  Inputs are
made with numpy from a seed and handed to both packages.

* ``GeluMLP`` against ``gelu_mlp``, and ``GQAttention`` against
  ``gqa_forward`` with ``qk_norm``, with ``qkv_bias`` and for audio: the
  output and every gradient (parameters and x) within rtol 1e-5 at f32.
* The distributed candidate: the port's dp2·tp2·sp candidates of reduced
  ``qwen3-32b`` (``q_norm`` / ``k_norm`` on the local heads, their
  gradients summed over tp) and ``codeqwen1.5-7b`` (the bias split with
  the fused QKV columns), and dp1·cp2·tp2 of ``qwen3-32b``, with those
  norms and biases off their constant init so that a wrong layout shows,
  pass the reference's ``compare_traces`` against the JAX candidate and
  the JAX reference under the reference's f32 thresholds; a VLM or audio
  candidate is refused, as the reference's cannot run them.
* Decode: logits of every step and the final caches match the reference's
  ``decode_step`` for ``qwen3-32b`` and ``codeqwen1.5-7b``, and
  ``serve.generate`` gives the greedy tokens of a loop over it; the CLI
  decodes both and refuses ``hubert-xlarge`` as encoder-only.
* The flash kernel's operand check takes D 80 and 112 (the head dims of
  ``qwen3-32b``, ``hubert-xlarge`` and zamba2's shared block) and still
  refuses D 32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (configs, jax_setup, one_thread,  # noqa: E402
                           to_jax_trace)
from repro.core.checker import compare_traces  # noqa: E402
from repro.core.collector import flatten_named  # noqa: E402
from repro.core.harness import make_model_runner as jax_runner  # noqa: E402
from repro.core.thresholds import MACHINE_EPS, estimate_thresholds  # noqa: E402
from repro.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim.adamw import AdamW as JaxAdamW  # noqa: E402
from repro.parallel import api as japi  # noqa: E402
from repro_torch.checkpoint.store import flatten_named as torch_flatten  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as TF  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.parallel.api import ParallelConfig, make_candidate_runner  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
LR = 1e-3
B, T = 2, 12
DIST = (("qwen3-32b", dict(dp=2, tp=2, sp=True)),
        ("codeqwen1.5-7b", dict(dp=2, tp=2, sp=True)),
        ("qwen3-32b", dict(dp=1, cp=2, tp=2)))


def setup_module():
    one_thread()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rtol * np.abs(want) + atol * max(1.0, float(np.abs(want).max()))
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def _randomize(p, rng, names):
    """``p`` with the leaves named (biases, norms) off their constant
    init, so that each one's use and gradient count."""
    named = {k: np.asarray(v) for k, v in flatten_named(p).items()}
    for k in names:
        named[k] = (named[k] + 0.3 * rng.standard_normal(named[k].shape)
                    ).astype(np.float32)
    leaves = [jnp.asarray(named[k]) for k in flatten_named(p)]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(p),
                                        leaves), named


def _grads_match(jf, p, x, g, mod, xt):
    """The JAX function's output and gradients (p, x) against the port
    module's on the same inputs; ``jf(p, x)`` -> y."""
    jy, vjp = jax.vjp(jf, p, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    ty = mod(xt)
    ty.backward(torch.tensor(g))
    _close(ty.detach().numpy(), jy, "y")
    _close(xt.grad.numpy(), jgx, "dx")
    jgrads = flatten_named(jgp)
    for name, prm in mod.named_parameters():
        _close(prm.grad.numpy(), jgrads[name], name)
    assert {n for n, _ in mod.named_parameters()} == set(jgrads)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_gelu_mlp_matches_the_reference():
    rng = np.random.default_rng(5)
    p = JL.gelu_mlp_init(jax.random.PRNGKey(2), 32, 64, jnp.float32, 0.05)
    p, named = _randomize(p, rng, ("fc1.b", "fc2.b"))
    mod = params_from_jax(named, TL.GeluMLP(torch.Generator().manual_seed(0),
                                            32, 64, torch.float32, 0.05))
    assert [n for n, _ in mod.named_parameters()] == [
        "fc1.w", "fc1.b", "fc2.w", "fc2.b"]
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    g = rng.standard_normal((2, 8, 32)).astype(np.float32)
    _grads_match(lambda p, x: JL.gelu_mlp(p, x), p, x, g, mod,
                 torch.tensor(x, requires_grad=True))


@pytest.mark.parametrize("name,extra", [
    ("qwen3-32b", ("q_norm", "k_norm")),
    ("codeqwen1.5-7b", ("linear_qkv.b",)),
    ("hubert-xlarge", ("linear_qkv.b",))])
def test_gqa_attention_matches_the_reference(name, extra):
    jcfg, tcfg = configs(name)
    if name == "hubert-xlarge":     # a biased QKV beside the rope-free path
        jcfg, tcfg = (dataclasses.replace(c, qkv_bias=True)
                      for c in (jcfg, tcfg))
    rng = np.random.default_rng(7)
    p = JA.gqa_init(jax.random.PRNGKey(3), jcfg, jnp.float32, 0.05)
    p, named = _randomize(p, rng, extra)
    mod = params_from_jax(named, TA.GQAttention(
        torch.Generator().manual_seed(0), tcfg, torch.float32, 0.05))
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    _grads_match(lambda p, x: JA.gqa_forward(p, jcfg, x), p, x, g, mod,
                 torch.tensor(x, requires_grad=True))
    if name == "hubert-xlarge":
        # no rope: a position's q and k do not depend on where it sits
        xt = torch.tensor(x)
        q, k, _ = mod._qkv(xt, torch.arange(16).expand(2, 16))
        q2, k2, _ = mod._qkv(xt, torch.zeros(2, 16, dtype=torch.long))
        assert torch.equal(q, q2) and torch.equal(k, k2)


# ---------------------------------------------------------------------------
# the distributed candidate
# ---------------------------------------------------------------------------

@pytest.fixture
def host_outputs(monkeypatch):
    """The reference runner's post-processing on host arrays, as
    ``tests/test_torch_parallel.py`` does (XLA:CPU's collective rendezvous
    under the suite's parallel load)."""
    step_for = japi._Plumbing.cached_shard_map

    def on_host(self, *args, **kwargs):
        fn = step_for(self, *args, **kwargs)
        return lambda *a: jax.tree.map(np.asarray, fn(*a))

    monkeypatch.setattr(japi._Plumbing, "cached_shard_map", on_host)


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """(params, named params, the JAX reference's f32 thresholds and trace,
    opt, opt state); the QKV biases and the q / k norms are randomized."""
    _, jm, params, named, batch = jax_setup(name)
    params, named = _randomize(params, np.random.default_rng(11), [
        k for k in named if k.endswith(("linear_qkv.b", "q_norm", "k_norm"))])
    opt = JaxAdamW(lr=LR)
    st = opt.init(params)
    thr, trace = estimate_thresholds(jax_runner(jm, params, opt, st), batch,
                                     MACHINE_EPS["float32"])
    return params, named, thr, trace, opt, st


@pytest.mark.parametrize("name,kw", DIST,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, kw in DIST])
def test_candidate_matches_jax_candidate_and_reference(
        forced_devices, host_outputs, name, kw):
    jcfg, tcfg = configs(name)
    batch = jax_setup(name)[4]
    params, named, thr, jref, jopt, st = _jax_reference(name)
    assert any(k.endswith(("linear_qkv.b", "q_norm")) for k in named)
    jcand = japi.make_candidate_runner(jcfg, japi.ParallelConfig(**kw),
                                       params, jopt, st)(batch, None)
    port = to_jax_trace(make_candidate_runner(
        tcfg, ParallelConfig(**kw), named, AdamW(lr=LR), device="cpu")(batch))
    for against in (jcand, jref):
        rep = compare_traces(against, port, thr)
        assert rep.passed and not rep.missing, rep.summary()
    assert port.meta["fwd_order"] == jcand.meta["fwd_order"]
    assert abs(port.loss - jcand.loss) <= 1e-5 * abs(jcand.loss)


@pytest.mark.parametrize("name", ["llava-next-34b", "hubert-xlarge"])
def test_candidate_refuses_a_frontend(name):
    _, tcfg = configs(name)
    with pytest.raises(ValueError, match="token batches only"):
        make_candidate_runner(tcfg, ParallelConfig(dp=2, tp=2),
                              jax_setup(name)[3], AdamW(lr=LR), device="cpu")


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------

def _pair(name, seed=1):
    """(jax model, jax params, port model) on the same parameters."""
    _, jm, params, named, _ = jax_setup(name, seed=seed)
    _, tcfg = configs(name)
    return jm, params, params_from_jax(named, Model(tcfg, device="cpu"))


@pytest.mark.parametrize("name", ["qwen3-32b", "codeqwen1.5-7b"])
def test_decode_and_generate_match_the_reference(name):
    jcfg, tcfg = configs(name)
    jm, params, model = _pair(name)
    toks = jnp.asarray(jax_make_batch(jcfg, B, T)["tokens"])
    dec = jax.jit(jm.decode_step)
    jcache, cache = jm.init_cache(B, T), model.init_cache(B, T)
    x = torch.tensor(np.asarray(toks))
    for t in range(T):
        jl, jcache = dec(params, jcache, toks[:, t:t + 1], jnp.int32(t))
        lg, cache = model.decode_step(cache, x[:, t:t + 1], t)
        _close(lg.numpy(), np.asarray(jl), f"logits t{t}")
    want = {k: np.asarray(v) for k, v in flatten_named(jcache).items()}
    got = torch_flatten(cache)
    assert list(got) == list(want)
    for k, leaf in got.items():
        _close(leaf.numpy(), want[k], f"cache {k}")

    # serve.generate at temperature 0 against the reference's greedy loop
    P, gen = 8, 6
    cache = jm.init_cache(B, P + gen)
    for t in range(P):
        logits, cache = dec(params, cache, toks[:, t:t + 1], jnp.int32(t))
    last = jnp.argmax(logits[:, 0], -1)[:, None]
    greedy = []
    for t in range(P, P + gen):
        logits, cache = dec(params, cache, last.astype(jnp.int32),
                            jnp.int32(t))
        greedy.append(np.asarray(last))
        last = jnp.argmax(logits[:, 0], -1)[:, None]
    got, _, _ = serve.generate(model, x[:, :P], gen)
    assert got.tolist() == np.concatenate(greedy, axis=1).tolist()


@pytest.mark.parametrize("name", ["qwen3-32b", "codeqwen1.5-7b"])
def test_serve_cli_decodes(name, capsys):
    out = serve.main(["--arch", name, "--reduced", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    assert tuple(out.shape) == (2, 3)
    assert "tok/s" in capsys.readouterr().out


def test_serve_cli_refuses_the_audio_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the flash kernel's head dims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [80, 112])
def test_kernel_operands_take_d_80_and_112(D):
    q = torch.zeros(1, 64, 2, D)
    # past the head-dim check: only the device is refused on the CPU
    with pytest.raises(ValueError, match="CUDA device"):
        TF.check_kernel_operands(q, q, q)
    q32 = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="D in"):
        TF.check_kernel_operands(q32, q32, q32)
    assert D in TF.HEAD_DIMS and 32 not in TF.HEAD_DIMS

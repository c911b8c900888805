"""Shared set-up of the PyTorch-port parity tests (``tests/test_torch_*.py``).

Parameters and batches come from the JAX package (``Model.init``,
``make_batch``) and cross to the port as numpy by ``flatten_named`` name.
Configs are ``gpt-paper`` and ``tinyllama-1.1b`` ``.reduced()`` with
``n_layers=2, vocab=256``.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core.collector import Trace as JaxTrace, flatten_named
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import get_config as torch_get_config
from repro_torch.core.collector import SECTION_FIELDS
from repro_torch.interop import params_from_jax, trace_to_numpy
from repro_torch.models.model import Model as TorchModel

CONFIGS = ("gpt-paper", "tinyllama-1.1b")
BATCH, SEQ = 2, 16


def configs(name):
    kw = dict(n_layers=2, vocab=256)
    return (dataclasses.replace(jax_get_config(name).reduced(), **kw),
            dataclasses.replace(torch_get_config(name).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def jax_setup(name, seed=1):
    """(jax cfg, jax model, jax params, numpy named params, numpy batch)."""
    jcfg, _ = configs(name)
    jm = JaxModel(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    named = {k: np.asarray(v) for k, v in flatten_named(params).items()}
    batch = {k: np.asarray(v) for k, v in jax_make_batch(jcfg, BATCH, SEQ).items()}
    return jcfg, jm, params, named, batch


def torch_model(name, named=None):
    """The port's Model on the CPU, loaded with the JAX parameters."""
    _, tcfg = configs(name)
    if named is None:
        named = jax_setup(name)[3]
    return params_from_jax(named, TorchModel(tcfg, device="cpu"))


def to_jax_trace(trace):
    """A port trace as a JAX ``Trace`` of numpy leaves."""
    nt = trace_to_numpy(trace)
    jt = JaxTrace()
    for f in SECTION_FIELDS:
        setattr(jt, f, getattr(nt, f).host())
    jt.loss, jt.grad_norm, jt.meta = nt.loss, nt.grad_norm, nt.meta
    return jt


def one_thread():
    """The suite runs under several xdist workers: keep torch to one thread."""
    torch.set_num_threads(1)

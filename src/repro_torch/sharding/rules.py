"""Sharding rules for the production mesh: the port of
``repro/sharding/rules.py``.

Maps parameter names, input kinds and cache kinds to ``PartitionSpec``s on
the (16,16)=("data","model") single-pod or (2,16,16)=("pod","data","model")
multi-pod mesh (``launch/mesh.make_production_mesh``).  Rules are written
against the TRAILING dims of each leaf, so a scan-stacked leaf (leading
layer dim) and the port's per-layer leaf resolve alike.  ``PARAM_RULES``
and every resolver are the reference's; ``PartitionSpec`` is the port's
own, a tuple of the entries, so ``tuple(jax_spec) == tuple(port_spec)``
compares them.

The port has no partitioner: ``NamedSharding`` only measures a shard
(``shard_shape``, ``shard_bytes``, which the dry run sums into per-device
argument bytes), and ``ShardingCtx``'s layout hints (``btd``, ``moe_buf``,
``grouped``, ``vmapped_buf``, ``grouped_buf``, ``flat_tokens``) return
``x`` unchanged.  A layout choice never changes a value (the reference's
GSPMD semantics), so nothing is lost by that.  ``dispatch_groups`` does
change values, the MoE dispatch's group count, and the port's
``models/moe.py`` calls it under ``activate`` as the reference's does.
"""
from __future__ import annotations

import fnmatch
import math
from dataclasses import dataclass
from typing import Optional

import torch

MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of axis names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_sizes(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in axes)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` over ``mesh``: what one device holds of a leaf."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for dim, entry in zip(shape, entries):
            n = _axis_sizes(self.mesh, entry)
            if dim % n:
                raise ValueError(f"dim {dim} does not split over {entry!r} "
                                 f"({n})")
            out.append(dim // n)
        return tuple(out)

    def shard_bytes(self, shape, dtype) -> int:
        itemsize = torch.empty((), dtype=dtype).element_size()
        return math.prod(self.shard_shape(shape)) * itemsize


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


# ---------------------------------------------------------------------------
# Parameter rules: (glob pattern on flattened name) -> trailing-dims spec
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple]] = [
    ("*embedding.word_embeddings", (MODEL_AXIS, None)),      # vocab-parallel
    ("*lm_head", (MODEL_AXIS, None)),
    ("*mask_embed", (None,)),
    ("*vision_proj.w", (None, MODEL_AXIS)),
    ("*audio_proj.w", (None, MODEL_AXIS)),
    # attention
    ("*linear_qkv.w", (None, MODEL_AXIS)),
    ("*linear_qkv.b", (MODEL_AXIS,)),
    ("*linear_proj.w", (MODEL_AXIS, None)),
    ("*q_norm", (None,)),
    ("*k_norm", (None,)),
    # MLA
    ("*linear_dq.w", (None, MODEL_AXIS)),
    ("*linear_uq.w", (None, MODEL_AXIS)),
    ("*linear_dkv.w", (None, None)),
    ("*linear_krope.w", (None, None)),
    ("*linear_uk.w", (None, MODEL_AXIS)),
    ("*linear_uv.w", (None, MODEL_AXIS)),
    # dense mlp
    ("*mlp.gate.w", (None, MODEL_AXIS)),
    ("*mlp.up.w", (None, MODEL_AXIS)),
    ("*mlp.down.w", (MODEL_AXIS, None)),
    ("*fc1.w", (None, MODEL_AXIS)),
    ("*fc1.b", (MODEL_AXIS,)),
    ("*fc2.w", (MODEL_AXIS, None)),
    # moe: expert-parallel when n_experts divides the axis, else shard the
    # ffn dim (mixtral's 8 experts < 16-way model axis)
    ("*experts.gate", [(MODEL_AXIS, None, None), (None, None, MODEL_AXIS)]),
    ("*experts.up", [(MODEL_AXIS, None, None), (None, None, MODEL_AXIS)]),
    ("*experts.down", [(MODEL_AXIS, None, None), (None, MODEL_AXIS, None)]),
    ("*mlp.router", (None, None)),
    ("*score_correction.b", (None,)),     # the port's V3 router bias
    ("*shared.gate.w", (None, MODEL_AXIS)),
    ("*shared.up.w", (None, MODEL_AXIS)),
    ("*shared.down.w", (MODEL_AXIS, None)),
    # mamba2
    ("*mixer.in_proj.w", (None, MODEL_AXIS)),
    ("*mixer.conv_w", (None, MODEL_AXIS)),
    ("*mixer.conv_b", (MODEL_AXIS,)),
    ("*mixer.out_proj.w", (MODEL_AXIS, None)),
    ("*mixer.gate_norm", (MODEL_AXIS,)),
    ("*mixer.A_log", (None,)),
    ("*mixer.D", (None,)),
    ("*mixer.dt_bias", (None,)),
    # rwkv6 time/channel mix
    ("*time_mix.recept.w", (None, MODEL_AXIS)),
    ("*time_mix.key.w", (None, MODEL_AXIS)),
    ("*time_mix.value.w", (None, MODEL_AXIS)),
    ("*time_mix.gate.w", (None, MODEL_AXIS)),
    ("*time_mix.out.w", (MODEL_AXIS, None)),
    ("*time_mix.decay_B", (None, MODEL_AXIS)),
    ("*time_mix.w0", (MODEL_AXIS,)),
    ("*time_mix.ln_out", (MODEL_AXIS,)),
    ("*time_mix.u", (MODEL_AXIS, None)),
    ("*channel_mix.key.w", (None, MODEL_AXIS)),
    ("*channel_mix.value.w", (MODEL_AXIS, None)),
    ("*channel_mix.recept.w", (None, MODEL_AXIS)),
]


def param_pspec(name: str, shape: tuple, mesh) -> PartitionSpec:
    """Resolve the rule for a flattened param name; leading (scan) dims get
    None.  A rule may give ALTERNATIVE specs (first whose sharded dims all
    divide wins); dims that don't divide fall back to replication."""
    cands: list[tuple] = [()]
    for pat, s in PARAM_RULES:
        if fnmatch.fnmatchcase(name, pat):
            cands = s if isinstance(s, list) else [s]
            break
    ndim = len(shape)

    def resolve(spec, strict):
        full = ([None] * (ndim - len(spec)) + list(spec))[:ndim]
        out = []
        for dim, ax in zip(shape, full):
            if ax is not None and dim % mesh.shape[ax] == 0:
                out.append(ax)
            elif ax is not None and strict:
                return None
            else:
                out.append(None)
        return P(*out)

    for spec in cands:
        r = resolve(spec, strict=True)
        if r is not None:
            return r
    return resolve(cands[0], strict=False)


def with_data_axis(spec: PartitionSpec, shape: tuple, mesh,
                   axes: tuple = ("data",)) -> PartitionSpec:
    """ZeRO-style densification: additionally shard the first dim that is
    unsharded and divisible — used for fp32 optimizer state."""
    size = math.prod(mesh.shape[a] for a in axes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, ax) in enumerate(zip(shape, entries)):
        if ax is None and dim % size == 0:
            entries[i] = axes if len(axes) > 1 else axes[0]
            return P(*entries)
    return spec


def param_shardings(named_shapes: dict, mesh, opt_state: bool = False
                    ) -> dict:
    out = {}
    for name, shp in named_shapes.items():
        spec = param_pspec(name, shp, mesh)
        if opt_state:
            spec = with_data_axis(spec, shp, mesh, dp_axes(mesh))
        out[name] = NamedSharding(mesh, spec)
    return out


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def batch_pspec(mesh, batch_size: int) -> PartitionSpec:
    """Shard the global batch over (pod, data) — dropping axes that don't
    divide (long_500k has batch 1)."""
    keep = []
    rem = batch_size
    for a in dp_axes(mesh):
        if rem % mesh.shape[a] == 0 and mesh.shape[a] > 1:
            keep.append(a)
            rem //= mesh.shape[a]
    if not keep:
        return P(None)
    return P(tuple(keep) if len(keep) > 1 else keep[0])


def seq_axes_for(mesh, batch_sharded: bool) -> Optional[tuple]:
    """When the batch can't be sharded (long-context decode), context-
    parallel the sequence/cache dim over the dp axes instead."""
    return None if batch_sharded else dp_axes(mesh)


def cache_pspec(path: str, shape: tuple, mesh, batch_sharded: bool,
                batch_dim: int) -> PartitionSpec:
    """Generic KV/state cache rule: batch dim over (pod,data) when it
    divides, else the longest dim (the sequence) context-parallel over the
    dp axes; one heads/feature dim over "model" where divisible."""
    entries: list = [None] * len(shape)
    dp = dp_axes(mesh)
    dp_size = _dp_size(mesh)
    if batch_sharded and shape[batch_dim] % dp_size == 0:
        entries[batch_dim] = dp if len(dp) > 1 else dp[0]
    else:
        # context-parallel: shard the largest (sequence) dim; the first of
        # equal ones, as numpy's argmax
        seq_dim = max(range(len(shape)), key=lambda i: (shape[i], -i))
        if shape[seq_dim] % dp_size == 0 and seq_dim != batch_dim:
            entries[seq_dim] = dp if len(dp) > 1 else dp[0]
    # one more dim over model, preferring trailing head-ish dims
    msize = mesh.shape[MODEL_AXIS]
    for i in range(len(shape) - 2, -1, -1):
        if entries[i] is None and i != batch_dim and shape[i] % msize == 0 \
                and shape[i] >= msize:
            entries[i] = MODEL_AXIS
            break
    return P(*entries)


# ---------------------------------------------------------------------------
# In-model sharding context
# ---------------------------------------------------------------------------

@dataclass
class ShardingCtx:
    """The active mesh.  The reference's layout hints are
    ``with_sharding_constraint``s; the port has no partitioner, and a layout
    never changes a value, so each returns ``x`` as it is."""
    mesh: object
    batch_sharded: bool = True

    def btd(self, x):
        """Residual-stream activations (B, S, d)."""
        return x

    def moe_buf(self, x):
        """Expert dispatch buffer (E, C, d)."""
        return x

    def grouped(self, x):
        """(G, ...) per-data-shard grouped tensors."""
        return x

    def vmapped_buf(self, x):
        """(E, C, d) buffer inside a grouped dispatch."""
        return x

    def grouped_buf(self, x):
        """(G, E, C, d) grouped dispatch buffers."""
        return x

    def flat_tokens(self, x):
        """(T[*k], d) flattened token tensors in the MoE dispatch."""
        return x


_CTX: list = []


def push_ctx(ctx: ShardingCtx):
    _CTX.append(ctx)


def pop_ctx():
    _CTX.pop()


def current() -> Optional[ShardingCtx]:
    return _CTX[-1] if _CTX else None


def constrain(x, kind: str):
    ctx = current()
    if ctx is None:
        return x
    return getattr(ctx, kind)(x)


def dispatch_groups(n_tokens: int, n_experts: int = 0) -> int:
    """Number of MoE dispatch groups: one per data shard when a sharding
    context is active (and the token count divides), else 1.

    Grouping only pays when the experts are truly expert-parallel
    (n_experts divisible by the model axis); otherwise (e.g. mixtral's 8
    experts on a 16-way axis) the reference keeps one group."""
    ctx = current()
    if ctx is None:
        return 1
    if n_experts and n_experts % ctx.mesh.shape[MODEL_AXIS] != 0:
        return 1
    dsz = _dp_size(ctx.mesh)
    return dsz if n_tokens % dsz == 0 and ctx.batch_sharded else 1


class activate:
    """``with rules.activate(mesh, batch_sharded):`` — makes ``mesh`` the
    current sharding context (``dispatch_groups`` reads it)."""

    def __init__(self, mesh, batch_sharded: bool = True):
        self.ctx = ShardingCtx(mesh, batch_sharded)

    def __enter__(self):
        push_ctx(self.ctx)
        return self.ctx

    def __exit__(self, *a):
        pop_ctx()

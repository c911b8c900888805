"""Emulated ``("dp", "cp", "tp")`` device mesh: the port's counterpart of
``repro/parallel/api.make_device_mesh`` and ``shard_map_unchecked``.

The reference runs every rank of a distributed candidate in one process,
as ``shard_map`` over forced host devices.  The port has one card, so the
ranks are emulated in one process: a per-rank value is a **rank-stacked**
tensor whose dim 0 holds every rank, in ``(dp, cp, tp)`` row-major order
(``core.merger.rank_coords``), and every op of the ``shard_map`` body runs
on all ranks at once.  Collectives are reductions and concatenations over
the rank dim, in a fixed order (rank 0 + rank 1 + ...), in the operands'
dtype as ``psum`` sums them; none uses atomics, so two runs are
bit-identical.  Separate processes or threads cannot share one card this
way: NCCL refuses two ranks of one communicator on one GPU, gloo moves
CUDA tensors through the host, and a collective's backward that waits for
another rank's thread deadlocks autograd's single backward thread.

Gradients follow ``shard_map`` with replication checks off: every rank's
loss seeds its own backward (the runner back-propagates their sum), and
each collective is an autograd function whose backward is its transpose
there — ``psum`` -> ``psum``, ``all_gather`` -> ``psum_scatter``,
``psum_scatter`` -> ``all_gather``, and ``first`` (rank 0's value on every
rank) -> the sum of every rank's cotangent into rank 0.

``collective_log()`` records every collective that runs inside it, the
backward's included, as ``(kind, operand bytes, result bytes)`` of one
rank: ``psum`` and ``pmax`` as ``"all-reduce"``, ``all_gather`` and
``first`` as ``"all-gather"``, ``psum_scatter`` and ``first``'s transpose
as ``"reduce-scatter"`` (``launch/hlo.collective_report`` sums them).  It
is off by default and changes no value.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import resolve_device
from repro_torch.core.merger import RANK_AXES

AXIS_DIM = {a: i for i, a in enumerate(RANK_AXES)}


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


_LOG: list | None = None


@contextlib.contextmanager
def collective_log():
    """Yield the list every mesh's collectives append to while inside."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


class Mesh:
    """``dp x cp x tp`` emulated ranks on one device.  Tensors are sharded
    onto its ranks and assembled from them by ``core.merger.split_ranks``
    and ``assemble_ranks``."""

    def __init__(self, dp: int = 1, cp: int = 1, tp: int = 1, device="cuda"):
        self.shape = (dp, cp, tp)
        self.sizes = dict(zip(RANK_AXES, self.shape))
        self.n_ranks = dp * cp * tp
        self.device = resolve_device(device)
        r = torch.arange(self.n_ranks)
        self._index = {a: v.to(self.device) for a, v in
                       (("dp", r // (cp * tp)), ("cp", r // tp % cp),
                        ("tp", r % tp))}

    # ---- rank coordinates ---------------------------------------------------
    def axis_size(self, name: str) -> int:
        return self.sizes[name]

    def axis_index(self, name: str) -> torch.Tensor:
        """Every rank's coordinate on axis ``name``: int64 ``(n_ranks,)``."""
        return self._index[name]

    @staticmethod
    def rank_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
        """A rank-stacked ``t`` (ranks, *s) viewed as (ranks, 1, ..., *s) with
        ``ndim`` dims, to broadcast against a rank-stacked activation."""
        return t.reshape(t.shape[:1] + (1,) * (ndim - t.ndim) + t.shape[1:])

    # ---- collectives ---------------------------------------------------------
    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(a for a in _axes(axes) if self.sizes[a] > 1)
        return _PSum.apply(x, self, axes) if axes else x

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Max over ``axis`` on every rank; not differentiable (the
        reference applies it to a stop-gradient value)."""
        if self.sizes[axis] == 1:
            return x
        g = self._grid(x.detach())
        return self._record("all-reduce", x, self._flat(
            g.amax(dim=AXIS_DIM[axis], keepdim=True).expand(g.shape)))

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Tiled all-gather: every rank gets the ranks' shards of ``axis``
        concatenated along local dim ``dim``."""
        if self.sizes[axis] == 1:
            return x
        return _AllGather.apply(x, self, axis, dim % (x.ndim - 1))

    def psum_scatter(self, x: torch.Tensor, axis: str, dim: int
                     ) -> torch.Tensor:
        """Tiled reduce-scatter: rank i of ``axis`` gets piece i (along local
        dim ``dim``) of the sum over ``axis``."""
        if self.sizes[axis] == 1:
            return x
        return _PSumScatter.apply(x, self, axis, dim % (x.ndim - 1))

    def first(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Coordinate 0's value on every rank of ``axis`` (``all_gather(x,
        axis)[0]`` in the reference)."""
        if self.sizes[axis] == 1:
            return x
        return _First.apply(x, self, axis)

    # ---- the raw reductions (no autograd) ------------------------------------
    def _record(self, kind: str, x: torch.Tensor, out: torch.Tensor
                ) -> torch.Tensor:
        if _LOG is not None:
            _LOG.append((kind, x.numel() // self.n_ranks * x.element_size(),
                         out.numel() // self.n_ranks * out.element_size()))
        return out

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.shape + tuple(x.shape[1:]))

    def _flat(self, g: torch.Tensor) -> torch.Tensor:
        return g.reshape((self.n_ranks,) + tuple(g.shape[3:]))

    @staticmethod
    def _sum(g: torch.Tensor, d: int) -> torch.Tensor:
        """Fixed-order sum over grid dim ``d`` (kept, size 1)."""
        parts = g.unbind(d)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.unsqueeze(d)

    def _psum(self, x, axes):
        g = self._grid(x)
        shape = g.shape
        for a in axes:
            g = self._sum(g, AXIS_DIM[a])
        return self._record("all-reduce", x, self._flat(g.expand(shape)))

    def _all_gather(self, x, axis, dim):
        g = self._grid(x)
        d = AXIS_DIM[axis]
        cat = torch.cat(g.unbind(d), dim=2 + dim).unsqueeze(d)
        return self._record("all-gather", x, self._flat(cat.expand(
            g.shape[:d] + (self.sizes[axis],) + cat.shape[d + 1:])))

    def _psum_scatter(self, x, axis, dim):
        d = AXIS_DIM[axis]
        s = self._sum(self._grid(x), d).squeeze(d)
        return self._record("reduce-scatter", x, self._flat(torch.stack(
            s.chunk(self.sizes[axis], dim=2 + dim), dim=d)))

    def _first(self, x, axis):
        g = self._grid(x)
        return self._record("all-gather", x, self._flat(
            g.narrow(AXIS_DIM[axis], 0, 1).expand(g.shape)))

    def _first_transpose(self, g, axis):
        d = AXIS_DIM[axis]
        grid = self._grid(g)
        out = torch.zeros_like(grid)
        out.narrow(d, 0, 1).copy_(self._sum(grid, d))
        return self._record("reduce-scatter", g, self._flat(out))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh._psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._psum(g, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._psum_scatter(g, ctx.axis, ctx.dim), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._psum_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_gather(g, ctx.axis, ctx.dim), None, None, None


class _First(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._first(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._first_transpose(g, ctx.axis), None, None

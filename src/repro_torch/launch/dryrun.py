"""Dry run: the port of ``repro/launch/dryrun.py`` as a meta-device memory
and cost plan.

Every (architecture x input shape) pair runs its step once on PyTorch's
``meta`` device, which allocates nothing: the model (``Model(cfg,
device="meta")``), ``AdamW.init``, ``steps.input_specs`` and
``steps.cache_specs`` are meta tensors, and the port's own
``make_train_step`` (``default_n_micro`` microbatches), ``make_prefill_step``
or ``make_serve_step`` (at ``pos = seq_len - 1``) runs under
``CostMode``, one dispatch mode that counts three things for every aten
op:

  * flops, by ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    count of the same ops);
  * bytes accessed: the operand bytes plus the result bytes of every op
    that is not a view;
  * the live bytes of the storages the ops make (each rounded up to the
    CUDA caching allocator's 512-byte block), and their peak.

Per-device semantics.  ``argument_bytes`` and ``output_bytes`` are exact:
the local shard bytes, under ``sharding/rules.py``, of the parameters,
the optimizer state (``opt_state=True``), the batch and the cache, the
reference's quantities.  The step runs the local program: the batch split
over the dp axes as ``batch_pspec`` splits it.  No sharding context is
active, so a MoE layer dispatches its local tokens as one group.  Where
the reference groups (``rules.dispatch_groups``), a group is one data
shard's tokens with that shard's capacity, which is this program.  Where
it does not (experts that do not divide the model axis), its one group
has the global batch's capacity, of which the local program's buffers
hold a ``dp``-th, up to rounding.  ``temp_bytes`` is the peak of what the
step allocates on top of its arguments (its outputs included, where they
are live at the peak), and ``peak_bytes = argument_bytes + temp_bytes``.
On a mesh whose model axis is 1 (``make_host_mesh()`` on one H100)
``temp_bytes``, ``flops`` and ``bytes_accessed`` are that device's exact
figures.  On the
production meshes the port has no partitioner to split activations over
"model": there they are upper bounds, and the record says so
(``"bound": "model axis unsplit"``; a batch that does not split adds
"sequence unsplit").  ``collectives`` is ``None`` for the model step on a
multi-device mesh and zero counts on the host mesh; ``dryrun_candidate``
fills it from the emulated mesh's log (``parallel/mesh.collective_log``).
``compile_s`` holds the meta run's seconds.

The train step is handed the model's own leaves as its parameters, so
they are held once (``launch/train.py`` keeps a second copy).  A train
step of more than two microbatches runs two and scales flops and bytes
by ``n_micro``: every microbatch does the same work, and the peak is
reached by the second, the f32 accumulator being live from the start
(``"microbatches_run": 2``).  A microbatch's share is the second's (the
first makes what the model caches, as the rope tables); the step's tail
after its microbatches is counted at ``n_micro`` (``_tail_cost``), and
so are the metric scalars it holds to its end (``_metric_held_bytes``).
Each plan starts with the rope tables uncached, as a new process: they
are made, and counted, once.  The step runs the plain model paths, as
the reference's dry run does: no kernel is reached.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --host
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b --shape train_4k --host --batch 1 --layers 24
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_report.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.checkpoint.store import flatten_named
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      get_config, list_configs)
from repro_torch.core.collector import named_params
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.hlo import collective_report
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers as layers_mod
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import mesh as pmesh
from repro_torch.sharding import rules

GIB = 1 << 30
HBM_BYTES = 80 * 10**9          # one H100's 80 GB
ALLOC_BLOCK = 512               # the CUDA caching allocator's rounding
SAMPLED_MICRO = 2


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _tensors(tree, out=None) -> list:
    """The tensors in nested lists, tuples and dicts (an op's arguments)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@functools.cache
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@functools.cache
def _decomposes(func) -> bool:
    """``func.decompose`` would not give ``NotImplemented``."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    return (dk in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))


def _same_data(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride()
            and a.dtype == b.dtype)


class CostMode(TorchDispatchMode):
    """Flops, bytes accessed and the live-storage peak of what runs inside.

    ``flops`` follows ``FlopCounterMode``: an op without a formula is
    decomposed where it can be and its parts counted.  ``bytes`` adds the
    operand and result bytes of each op but views (and a ``copy_`` of a
    tensor onto itself, which moves nothing).  A storage an op makes counts
    from that op until its last tensor dies; ``live`` is their sum and
    ``peak`` its maximum.  Storages that existed before the mode (the
    step's arguments) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes: dict[int, int] = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default and \
                _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not _is_view(func) and not (
                func is torch.ops.aten.copy_.default
                and _same_data(args[0], args[1])):
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_keys or key in self._sizes:
                continue
            size = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
            self._sizes[key] = size
            self.live += size
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def dp_total(mesh) -> int:
    return math.prod(mesh.shape[a] for a in rules.dp_axes(mesh))


def batch_shardings(specs: dict, mesh, batch_sharded: bool) -> dict:
    """The reference's ``_batch_shardings``: batch over the dp axes, else a
    long token dim context-parallel."""
    out = {}
    for k, v in specs.items():
        if k == "pos" or v.ndim == 0:
            out[k] = rules.NamedSharding(mesh, rules.P())
            continue
        bspec = rules.batch_pspec(mesh, v.shape[0])
        spec = rules.P(*(list(bspec) + [None] * (v.ndim - len(bspec))))
        if not batch_sharded and v.ndim >= 2 and k in ("tokens", "labels",
                                                       "features"):
            dp = rules.dp_axes(mesh)
            if v.shape[1] % dp_total(mesh) == 0:
                spec = rules.P(None, dp if len(dp) > 1 else dp[0])
        out[k] = rules.NamedSharding(mesh, spec)
    return out


def cache_shardings(cache: dict, mesh, batch_sharded: bool) -> dict:
    """``{flat name: NamedSharding}`` of the port's per-layer caches: every
    leaf has its batch at dim 0."""
    return {name: rules.NamedSharding(mesh, rules.cache_pspec(
                name, tuple(leaf.shape), mesh, batch_sharded, batch_dim=0))
            for name, leaf in flatten_named(cache).items()}


def tree_shard_bytes(named: dict, shardings: dict) -> int:
    return sum(shardings[k].shard_bytes(tuple(v.shape), v.dtype)
               for k, v in named.items())


def param_bytes(named: dict, mesh, opt_state: bool = False) -> int:
    sh = rules.param_shardings({k: tuple(v.shape) for k, v in named.items()},
                               mesh, opt_state=opt_state)
    return tree_shard_bytes(named, sh)


def local_batch(specs: dict, mesh) -> dict:
    """Meta stand-ins of one device's batch: dim 0 split as
    ``batch_pspec`` splits it (the step runs the local program)."""
    out = {}
    for k, v in specs.items():
        if v.ndim == 0:
            out[k] = v
            continue
        n = rules.NamedSharding(mesh, rules.batch_pspec(mesh, v.shape[0]))
        rows = n.shard_shape(tuple(v.shape[:1]))[0]
        out[k] = steps_mod.spec((rows,) + tuple(v.shape[1:]), v.dtype)
    return out


def _metric_specs(loss, metrics: dict) -> list:
    """(shape, dtype) of each per-microbatch metric ``make_train_step``
    averages: the loss and ``Model.loss``'s metrics."""
    return [(tuple(v.shape), v.dtype) for v in (loss, *metrics.values())]


def _tail_cost(accum: list, specs: list, n: int) -> tuple:
    """Flops and bytes of what ``make_train_step`` does between its last
    microbatch and ``opt.update`` at ``n`` microbatches: each f32
    accumulator (``accum``: their shapes) divided by ``n``, each metric
    stacked and averaged."""
    grads = [torch.empty(s, dtype=torch.float32, device="meta")
             for s in accum]
    metrics = [[torch.empty(s, dtype=dt, device="meta") for _ in range(n)]
               for s, dt in specs]
    mode = CostMode()
    with mode:
        for g in grads:
            g.div_(n)
        for ts in metrics:
            torch.stack(ts).mean()
    return mode.flops, mode.bytes


def _metric_held_bytes(specs: list) -> int:
    """The allocator's bytes for one microbatch's metrics, which
    ``make_train_step`` holds until it returns."""
    return sum(-(-math.prod(s) * dt.itemsize // ALLOC_BLOCK) * ALLOC_BLOCK
               for s, dt in specs)


def _bound(mesh, batch_sharded: bool):
    parts = []
    if mesh.shape[rules.MODEL_AXIS] > 1:
        parts.append("model axis unsplit")
    if not batch_sharded and dp_total(mesh) > 1:
        parts.append("sequence unsplit")
    return ", ".join(parts) or None


# ---------------------------------------------------------------------------
# one pair
# ---------------------------------------------------------------------------

def dryrun_config(cfg: ArchConfig, shape: InputShape, mesh,
                  n_micro: int | None = None,
                  sample_micro: int | None = SAMPLED_MICRO) -> dict:
    """The record of one (config, shape) step on ``mesh``, without the
    arch/shape names.  ``n_micro`` (train) defaults to ``default_n_micro``;
    a step of more than ``sample_micro`` microbatches runs that many and
    scales (``None``: runs them all)."""
    t0 = time.time()
    # a new process's first step: the rope tables are made in it
    layers_mod._rope_table.cache_clear()
    model = Model(cfg, device="meta")
    params = {k: p.detach() for k, p in named_params(model).items()}
    specs = steps_mod.input_specs(cfg, shape)
    batch_sharded = shape.global_batch % dp_total(mesh) == 0
    b_sh = batch_shardings(specs, mesh, batch_sharded)
    parts = {"params": param_bytes(params, mesh),
             "batch": tree_shard_bytes(specs, b_sh)}
    batch = local_batch(specs, mesh)
    mode = CostMode()
    rec = {"n_micro": 1}
    if shape.kind == "train":
        opt = AdamW(lr=1e-4)
        opt_state = opt.init(params)
        # master, m and v, each keyed by the parameter names
        parts["opt_state"] = sum(
            param_bytes(leaves, mesh, opt_state=True)
            for leaves in opt_state.values() if isinstance(leaves, dict))
        if n_micro is None:
            n_micro = steps_mod.default_n_micro(cfg, shape,
                                                dp_total(mesh))
        rows = next(iter(batch.values())).shape[0]
        runs = n_micro
        if sample_micro is not None and n_micro > sample_micro:
            runs = sample_micro
            batch = {k: steps_mod.spec(
                (rows // n_micro * runs,) + tuple(v.shape[1:]), v.dtype)
                for k, v in batch.items()}
        # the counts as each microbatch's loss starts and as the update
        # starts: the last microbatch's share is the last interval less
        # the tail (the first may hold one-time work, as the rope tables)
        marks, metric_specs, loss, update = [], [], model.loss, opt.update

        def marked(*a, **kw):
            marks.append((mode.flops, mode.bytes))
            out = loss(*a, **kw)
            if not metric_specs:
                metric_specs.extend(_metric_specs(*out))
            return out

        def marked_update(*a, **kw):
            marks.append((mode.flops, mode.bytes))
            return update(*a, **kw)
        model.loss, opt.update = marked, marked_update
        step = steps_mod.make_train_step(model, opt, n_micro=runs)
        with mode:
            new_p, new_st, metrics = step(params, opt_state, batch)
        del model.loss, opt.update
        flops, nbytes, temp = mode.flops, mode.bytes, mode.peak
        if runs < n_micro:
            accum = [tuple(v.shape) for v in params.values()]
            tf, tb = _tail_cost(accum, metric_specs, runs)
            nf, nb = _tail_cost(accum, metric_specs, n_micro)
            flops += ((n_micro - runs) * (marks[-1][0] - marks[-2][0] - tf)
                      + nf - tf)
            nbytes += ((n_micro - runs) * (marks[-1][1] - marks[-2][1] - tb)
                       + nb - tb)
            # each microbatch's metrics stay live to the step's end
            temp += (n_micro - runs) * _metric_held_bytes(metric_specs)
            rec["microbatches_run"] = runs
        rec["n_micro"] = n_micro
        out_bytes = (parts["params"] + parts["opt_state"]
                     + sum(map(_nbytes, _tensors(metrics))))
        del new_p, new_st, metrics
    elif shape.kind == "prefill":
        step = steps_mod.make_prefill_step(model)
        with mode:
            logits = step(batch)
        flops, nbytes, temp = mode.flops, mode.bytes, mode.peak
        out_bytes = _nbytes(logits)
    else:
        b_local = batch["tokens"].shape[0]
        cache = model.init_cache(b_local, shape.seq_len, device="meta")
        full = steps_mod.cache_specs(model, shape)
        parts["cache"] = tree_shard_bytes(
            flatten_named(full),
            cache_shardings(full, mesh, batch_sharded))
        step = steps_mod.make_serve_step(model)
        with mode:
            logits, cache = step(cache, {"tokens": batch["tokens"],
                                         "pos": shape.seq_len - 1})
        flops, nbytes, temp = mode.flops, mode.bytes, mode.peak
        out_bytes = _nbytes(logits) + parts["cache"]
    args = sum(parts.values())
    rec.update({
        "mesh": dict(mesh.shape),
        "device": "meta",
        "compile_s": round(time.time() - t0, 1),
        "flops": float(flops),
        "bytes_accessed": float(nbytes),
        "per_device": {
            "argument_bytes": int(args),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(temp),
            "peak_bytes": int(args + temp),
        },
        "argument_parts": parts,
        "bound": _bound(mesh, batch_sharded),
        "collectives": (collective_report([]) if mesh.size == 1 else None),
    })
    return rec


def _print(rec: dict) -> None:
    pd = rec["per_device"]
    coll = rec["collectives"]
    ctext = ("n/a" if coll is None else
             f"{coll['total']['operand_bytes'] / GIB:.3f} GiB "
             f"({coll['total']['count']} ops)")
    fits = "fits" if pd["peak_bytes"] <= HBM_BYTES else "does not fit"
    mesh = "x".join(str(v) for v in rec["mesh"].values())
    print(f"[{rec['arch']} x {rec['shape']} on {mesh}] OK in "
          f"{rec['compile_s']}s | args {pd['argument_bytes'] / GIB:.2f} GiB"
          f" + temp {pd['temp_bytes'] / GIB:.2f} GiB = "
          f"{pd['peak_bytes'] / GIB:.2f} GiB per device of 80 GB: {fits}"
          f"{' (' + rec['bound'] + ')' if rec['bound'] else ''} | flops "
          f"{rec['flops']:.3e} | coll {ctext}", flush=True)


def dryrun_pair(arch: str, shape_name: str, multi_pod: bool = False,
                verbose: bool = True, mesh=None, *, n_layers=None,
                batch=None, seq=None) -> dict:
    """The reference's record for one pair; ``mesh`` (default the
    production mesh) may be ``make_host_mesh()``.  ``n_layers``, ``batch``
    and ``seq`` cut the config's depth and set the shape's global batch and
    length (a plan of what a card run would hold)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = dataclasses.replace(shape, global_batch=batch or
                                shape.global_batch, seq_len=seq or
                                shape.seq_len)
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "status": "ok",
           "multi_pod": "pod" in mesh.axis_names,
           **dryrun_config(cfg, shape, mesh)}
    if (n_layers, batch, seq) != (None, None, None):
        rec["cut"] = {"n_layers": cfg.n_layers, "global_batch":
                      shape.global_batch, "seq_len": shape.seq_len}
    if verbose:
        _print(rec)
    return rec


# ---------------------------------------------------------------------------
# the distributed candidate
# ---------------------------------------------------------------------------

def dryrun_candidate(cfg, shape, pcfg, verbose: bool = True) -> dict:
    """One ``parallel/api.make_candidate_train_step`` step of ``cfg`` (a
    config or an arch name) under ``pcfg`` on meta, every emulated rank in
    one rank-stacked program, with the collective log on.  ``shape``: an
    ``InputShape`` or a name.  ``rank_stacked_peak_bytes`` is the
    program's arguments plus its temp peak; the per-rank figures divide
    the rank-stacked ones by ``n_ranks``."""
    from repro_torch.parallel.api import make_candidate_train_step
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    t0 = time.time()
    model = Model(cfg, device="meta")
    opt = AdamW(lr=1e-4)
    step, params, opt_state = make_candidate_train_step(
        cfg, pcfg, named_params(model), opt, device="meta")
    del model
    batch = {k: v for k, v in steps_mod.input_specs(cfg, shape).items()
             if k in ("tokens", "labels")}
    args = (sum(map(_nbytes, params.values()))
            + sum(_nbytes(t) for t in _tensors(opt_state))
            + sum(map(_nbytes, batch.values())))
    mode = CostMode()
    with pmesh.collective_log() as log, mode:
        out = step(params, opt_state, batch)
    del out
    n = pcfg.dp * pcfg.cp * pcfg.tp
    rec = {"arch": cfg.name, "shape": shape.name, "status": "ok",
           "pcfg": {k: getattr(pcfg, k) for k in ("dp", "cp", "tp", "sp",
                                                  "zero1")},
           "n_ranks": n, "device": "meta",
           "compile_s": round(time.time() - t0, 1),
           "flops": float(mode.flops), "bytes_accessed": float(mode.bytes),
           "rank_stacked_peak_bytes": int(args + mode.peak),
           "per_device": {"argument_bytes": args // n,
                          "temp_bytes": mode.peak // n,
                          "peak_bytes": (args + mode.peak) // n},
           "collectives": collective_report(log)}
    if verbose:
        c = rec["collectives"]["total"]
        print(f"[{cfg.name} candidate {rec['pcfg']} x {shape.name}] OK in "
              f"{rec['compile_s']}s | rank-stacked peak "
              f"{rec['rank_stacked_peak_bytes'] / GIB:.2f} GiB, per rank "
              f"{rec['per_device']['peak_bytes'] / GIB:.2f} GiB | flops "
              f"{rec['flops']:.3e} | coll {c['operand_bytes'] / GIB:.3f} GiB"
              f" ({c['count']} ops)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="the mesh of this host's cards (make_host_mesh)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every config to this depth")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch instead of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's length instead of its own")
    args = ap.parse_args(argv)
    cut = dict(n_layers=args.layers, batch=args.batch, seq=args.seq)

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    if args.host:
        meshes = [make_host_mesh()]
    else:
        meshes = [make_production_mesh(multi_pod=mp) for mp in
                  ([False, True] if args.both_meshes else [args.multi_pod])]
    records = []
    failures = 0
    for arch in archs:
        if arch == "gpt-paper" and args.all:
            continue   # paper model exercised via benchmarks, not assigned
        for shape in shapes:
            for mesh in meshes:
                try:
                    records.append(dryrun_pair(arch, shape, mesh=mesh,
                                               **cut))
                except Exception as e:
                    failures += 1
                    traceback.print_exc()
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": dict(mesh.shape),
                                    "status": "fail",
                                    "error": f"{type(e).__name__}: {e}"})
    n_ok = sum(1 for r in records if r["status"] == "ok")
    n_skip = sum(1 for r in records if r["status"] == "skip")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{failures} FAILED")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print("wrote", args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

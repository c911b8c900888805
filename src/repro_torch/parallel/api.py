"""Candidate-runner builder for the distributed GPT: the port of
``repro/parallel/api.py``.

``make_candidate_runner`` turns (ArchConfig, ParallelConfig, reference
params) into a ``runner(batch, rewrites) -> Trace`` with the SAME canonical
tap names as the single-device reference — the distributed half of TTrace's
differential test.

Plumbing responsibilities:
  * build the emulated ("dp","cp","tp") mesh (``parallel.mesh``) and shard
    params/batch/rewrites per the generated annotations (the programmatic
    equivalent of the paper's Fig 2 user annotations);
  * zigzag-permute sequence-dim inputs for context parallelism and
    un-permute collected taps back to logical order (paper Fig 6 layout);
  * post-backward gradient reductions over dp/cp/tp per tensor — the
    bug-injection site for the loss-scaling and missing-all-reduce bugs;
  * the optimizer step (plain AdamW or ZeRO-1) with main-grad and post-step
    parameter tracing.

The forward runs eagerly, so the taps are known once it has run: there is
no separate tap-discovery pass and no compiled-step cache.  Every rank's
tap, probe gradient and parameter gradient is assembled into the logical
full tensor as the reference's ``out_specs`` do (coordinate 0 of every
axis the spec does not shard), on the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bugs.registry import check_injectable
from repro_torch.core.annotations import Annotations, ShardSpec
from repro_torch.core.collector import Trace
from repro_torch.core.merger import assemble_ranks, split_ranks
from repro_torch.core.tap import TraceContext
from repro_torch.interop import as_tensor
from repro_torch.parallel.gpt import parallel_gpt_loss
from repro_torch.parallel.layers import (one_rank, permute_from_zigzag,
                                         permute_to_zigzag)
from repro_torch.parallel.mesh import Mesh
from repro_torch.parallel.zero import zero1_update


@dataclass(frozen=True)
class ParallelConfig:
    dp: int = 1
    cp: int = 1
    tp: int = 1
    sp: bool = False
    zero1: bool = False
    pp: int = 1                  # pipeline candidate (parallel.pp / pp1f1b)
    pp_schedule: str = "staged"  # staged (single-controller) | 1f1b
    microbatches: int = 1        # 1F1B microbatch count
    fp8: Optional[str] = None    # FP8 recipe: global | per_tensor | tile128
    bugs: frozenset = frozenset()

    @property
    def n_devices(self):
        # staged pp and fp8 are single-controller candidate recipes — they
        # model semantics (stage division, quantization), not placement;
        # the reference's 1F1B engine places one pipeline stage per device
        # (the port's emulates its stages on one)
        base = self.dp * self.cp * self.tp
        if self.pp > 1 and self.pp_schedule == "1f1b":
            return base * self.pp
        return base

    @property
    def features(self) -> set:
        f = set()
        if self.dp > 1: f.add("dp")
        if self.cp > 1: f.add("cp")
        if self.tp > 1: f.add("tp")
        if self.sp: f.add("sp")
        if self.zero1: f.add("zero1")
        if self.pp > 1: f.add("pp")
        if self.pp > 1 and self.pp_schedule == "1f1b": f.add("1f1b")
        if self.fp8: f.add("fp8")
        return f

    @property
    def recipe_kind(self) -> str:
        """Which candidate implementation drives this config."""
        if self.fp8 and self.pp > 1:
            raise ValueError("pp + fp8 in one candidate is not supported")
        if self.pp_schedule not in ("staged", "1f1b"):
            raise ValueError(f"unknown pp_schedule {self.pp_schedule!r}")
        if self.fp8:
            return "fp8"
        if self.pp > 1:
            return "pp_1f1b" if self.pp_schedule == "1f1b" else "pp"
        return "shard_map"


def candidate_features(cfg, pcfg: ParallelConfig) -> set:
    """The features a candidate of ``cfg`` under ``pcfg`` runs: ``pcfg``'s,
    and ``moe`` when the arch has MoE blocks to inject into (an arch-side
    feature, satisfied by the model)."""
    return pcfg.features | ({"moe"} if cfg.moe is not None else set())


def param_dtypes(cfg):
    """``name -> dtype`` each parameter is kept in, as the reference's
    ``Model.init`` makes it: the config's param dtype, and f32 for the MoE
    router (``moe_init``) and the port's score-correction bias."""
    dt = getattr(torch, cfg.param_dtype)
    return lambda name: (torch.float32 if name.endswith(
        ("mlp.router", "mlp.score_correction.b")) else dt)


def make_mesh(pcfg: ParallelConfig, device="cuda") -> Mesh:
    """The emulated mesh of ``pcfg``'s dp/cp/tp ranks on ``device``."""
    return Mesh(pcfg.dp, pcfg.cp, pcfg.tp, device=device)


# ---------------------------------------------------------------------------
# Annotation generation (what a user would write by hand, paper Fig 2)
# ---------------------------------------------------------------------------

def build_annotations(cfg, pcfg: ParallelConfig) -> Annotations:
    sp = pcfg.sp
    cp = pcfg.cp > 1
    seqspec = dict(cp_dim=1 if cp else None, cp_mode="zigzag",
                   sp_dim=1 if sp else None, dp_dim=0)
    params = {
        "embedding.word_embeddings": {"tp_dim": 0},
        "lm_head": {"tp_dim": 0},
        "layers.*.self_attention.linear_qkv.w": {"tp_dim": 1},
        "layers.*.self_attention.linear_qkv.b": {"tp_dim": 0},
        "layers.*.self_attention.linear_proj.w": {"tp_dim": 0},
        "layers.*.mlp.gate.w": {"tp_dim": 1},
        "layers.*.mlp.up.w": {"tp_dim": 1},
        "layers.*.mlp.down.w": {"tp_dim": 0},
        "layers.*.mlp.experts.gate": {"tp_dim": 0},   # expert dim
        "layers.*.mlp.experts.up": {"tp_dim": 0},
        "layers.*.mlp.experts.down": {"tp_dim": 0},
    }
    if cfg.attn == "mla":
        # heads over tp: each head's columns are contiguous, so a tp shard
        # of the columns is its heads' (no layout permutation); the latent
        # and the rope key are replicated
        for leaf in ("linear_q", "linear_uq", "linear_uk", "linear_uv"):
            params[f"layers.*.self_attention.{leaf}.w"] = {"tp_dim": 1}
    if cfg.moe is not None:
        for leaf, dim in (("gate", 1), ("up", 1), ("down", 0)):
            params[f"layers.*.mlp.shared.{leaf}.w"] = {"tp_dim": dim}
        # an MoE arch's leading dense layers shard as any layer's
        params.update({"dense_" + k: v for k, v in params.items()
                       if k.startswith("layers.*.")})
    acts = {
        "embedding/output": seqspec,
        "layers.*.self_attention/input": seqspec,
        "layers.*.self_attention/core_attn_out":
            {"tp_dim": -1, "cp_dim": 1 if cp else None, "cp_mode": "zigzag",
             "dp_dim": 0},
        "layers.*.self_attention/output": seqspec,
        "layers.*.mlp/input": seqspec,
        "layers.*.mlp/output": seqspec,
        "layers.*.mlp/router_logits":
            {"cp_dim": 1 if cp else None, "cp_mode": "zigzag", "dp_dim": 0},
        "final_norm_out": seqspec,
    }
    return Annotations.from_dict({"params": params, "acts": acts})


def sizes_coords(pcfg: ParallelConfig):
    return {"dp": pcfg.dp, "cp": pcfg.cp, "tp": pcfg.tp,
            "sp": pcfg.tp if pcfg.sp else 1}


# ---------------------------------------------------------------------------
# Gradient reduction rules (the bug surface)
# ---------------------------------------------------------------------------

# MLA's replicated leaves, read by every head (``tp_mla_attention``)
MLA_REPLICATED = ("linear_dkv.w", "kv_lora_norm", "linear_krope.w",
                  "linear_dq.w", "q_lora_norm")


def _needs_tp_reduce(name: str, pcfg: ParallelConfig) -> bool:
    if name.endswith("q_norm") or name.endswith("k_norm"):
        return pcfg.tp > 1          # head-sharded compute, always partial
    if name.endswith(MLA_REPLICATED):
        return pcfg.tp > 1          # each rank backprops its own heads
    if name.endswith("router"):
        # expert-parallel: each rank backprops only its local experts'
        # combine weights into the (replicated) router — the grads are
        # partial and must be all-reduced over the EP (= tp) group.  This is
        # the sync Megatron's bug 6 family is about.
        return pcfg.tp > 1
    norm_like = name.endswith(("input_norm", "post_attn_norm", "final_norm"))
    return pcfg.sp and pcfg.tp > 1 and norm_like


def reduce_param_grads(mesh: Mesh, pg_named: dict, pcfg: ParallelConfig,
                       bugs):
    out = {}
    for name, g in pg_named.items():
        if pcfg.dp > 1:
            g = mesh.psum(g, "dp")
            if "dp_wrong_loss_scale" not in bugs:
                g = g / pcfg.dp
        if pcfg.cp > 1:
            skip_cp = ("tp_cp_wrong_norm_grad" in bugs
                       and name.endswith("input_norm") and pcfg.tp > 1)
            if skip_cp:
                g = one_rank(mesh, g, "cp")   # per-rank partial, silently wrong
            else:
                g = mesh.psum(g, "cp")
                if "cp_wrong_loss_scale" not in bugs:
                    g = g / pcfg.cp
        if _needs_tp_reduce(name, pcfg):
            skip = (("sp_layernorm_not_synced" in bugs
                     and name.endswith("post_attn_norm"))
                    or ("tp_missing_grad_allreduce" in bugs
                        and name.endswith("input_norm")))
            if skip:
                g = one_rank(mesh, g, "tp")   # per-rank partial, silently wrong
            else:
                g = mesh.psum(g, "tp")
        out[name] = g
    return out


def reduce_act_grads(mesh: Mesh, ag: dict, ann: Annotations,
                     pcfg: ParallelConfig, bugs):
    """Activation-gradient (probe) scaling.  The tp accumulation is already
    handled by the f/g conjugate operators inside the layers; what remains is
    the dp/cp loss averaging — the same scale factors whose bugs (3, 4) the
    paper catalogues."""
    out = {}
    for name, g in ag.items():
        if pcfg.tp > 1 and name.endswith("router_logits"):
            # dispatch + (tp-partialized) aux contributions sum over tp
            g = mesh.psum(g, "tp")
        if pcfg.dp > 1 and "dp_wrong_loss_scale" not in bugs:
            g = g / pcfg.dp
        if pcfg.cp > 1 and "cp_wrong_loss_scale" not in bugs:
            g = g / pcfg.cp
        out[name] = g
    return out


# ---------------------------------------------------------------------------
# Recipe dispatch (pp / 1F1B / fp8 candidates share the supervisor contract)
# ---------------------------------------------------------------------------

def _check_recipe_pcfg(cfg, pcfg: ParallelConfig) -> None:
    if pcfg.dp * pcfg.cp * pcfg.tp != 1 or pcfg.zero1 or pcfg.sp:
        raise ValueError(
            f"the {pcfg.recipe_kind} candidate cannot combine with "
            f"dp/cp/tp/zero1 (got {pcfg})")
    if pcfg.microbatches > 1 and pcfg.recipe_kind != "pp_1f1b":
        # only the 1F1B engine executes microbatches; anywhere else the
        # flag would be a silent no-op
        raise ValueError(
            f"microbatches={pcfg.microbatches} applies to the 1F1B "
            f"pipeline only (recipe {pcfg.recipe_kind})")
    if cfg.arch_type != "dense":
        # fp8 quantizes the dense MLP matmuls only and the pp losses
        # partition homogeneous attn_mlp stacks; running other arches would
        # be a silent no-op — the injected bug never expresses and a clean
        # PASS means nothing
        raise ValueError(
            f"the {pcfg.recipe_kind} candidate covers dense arches only "
            f"(got arch_type={cfg.arch_type!r})")


def _recipe_model(cfg, pcfg: ParallelConfig, ref_params, device):
    """The recipe candidate's own ``Model`` holding ``ref_params``."""
    _check_recipe_pcfg(cfg, pcfg)
    from repro_torch.core.collector import load_params, named_params
    from repro_torch.models.model import Model
    model = Model(cfg, device=device)
    load_params(named_params(model),
                {n: _on(v, device) for n, v in _named(ref_params).items()})
    return model


def _recipe_runner(cfg, pcfg: ParallelConfig, ref_params: dict, opt,
                   opt_state, device):
    model = _recipe_model(cfg, pcfg, ref_params, device)
    if pcfg.recipe_kind == "pp":
        from repro_torch.parallel.pp import make_pp_runner
        return make_pp_runner(model, pcfg.pp, opt=opt, opt_state=opt_state,
                              bugs=pcfg.bugs, device=device)
    if pcfg.recipe_kind == "pp_1f1b":
        from repro_torch.parallel.pp1f1b import make_pp1f1b_runner
        return make_pp1f1b_runner(model, pcfg.pp, pcfg.microbatches,
                                  opt=opt, opt_state=opt_state,
                                  bugs=pcfg.bugs, device=device)
    from repro_torch.precision.fp8 import make_fp8_runner
    return make_fp8_runner(model, pcfg.fp8, opt=opt, opt_state=opt_state,
                           bugs=pcfg.bugs, device=device)


def _recipe_train_step(cfg, pcfg: ParallelConfig, ref_params, opt, device):
    model = _recipe_model(cfg, pcfg, ref_params, device)
    if pcfg.recipe_kind == "pp":
        from repro_torch.parallel.pp import make_pp_train_step
        return make_pp_train_step(model, opt, pcfg.pp, bugs=pcfg.bugs,
                                  device=device)
    if pcfg.recipe_kind == "pp_1f1b":
        from repro_torch.parallel.pp1f1b import make_pp1f1b_train_step
        return make_pp1f1b_train_step(model, opt, pcfg.pp, pcfg.microbatches,
                                      bugs=pcfg.bugs, device=device)
    from repro_torch.precision.fp8 import make_fp8_train_step
    return make_fp8_train_step(model, opt, pcfg.fp8, bugs=pcfg.bugs,
                               device=device)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

def qkv_permutation(cfg, tp: int) -> np.ndarray:
    """Column permutation mapping the reference fused-QKV layout [Q|K|V] to
    the tensor-parallel layout [q_0|k_0|v_0 | q_1|k_1|v_1 | ...] so that a
    contiguous tp shard holds its own heads' q, k and v.

    This is the paper's "mapping of semantics" problem in miniature: the
    candidate framework stores the same logical parameter in a different
    physical layout, and the tensor canonical mapping must undo it."""
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = np.arange(H * D).reshape(tp, -1)
    k = H * D + np.arange(Hkv * D).reshape(tp, -1)
    v = (H + Hkv) * D + np.arange(Hkv * D).reshape(tp, -1)
    return np.concatenate([np.concatenate([q[r], k[r], v[r]])
                           for r in range(tp)])


def layout_maps(cfg, tp: int):
    """``(to_candidate, from_candidate)`` leaf mappers over the QKV layout
    permutation — the single source of the reference<->candidate parameter
    layout (numpy arrays or tensors)."""
    perm = qkv_permutation(cfg, tp)
    inv_perm = np.argsort(perm)
    on_device = {}

    def index(leaf, p):
        # a device's index is made once: a copy per call would wait for it
        if isinstance(leaf, torch.Tensor):
            key = (id(p), leaf.device)
            if key not in on_device:
                on_device[key] = torch.as_tensor(p, device=leaf.device)
            return on_device[key]
        return p

    def to_candidate(name, leaf):
        if name.endswith("linear_qkv.w"):
            return leaf[:, index(leaf, perm)]
        if name.endswith("linear_qkv.b"):
            return leaf[index(leaf, perm)]
        return leaf

    def from_candidate(name, leaf):
        if name.endswith("linear_qkv.w"):
            return leaf[:, index(leaf, inv_perm)]
        if name.endswith("linear_qkv.b"):
            return leaf[index(leaf, inv_perm)]
        return leaf

    return to_candidate, from_candidate


def _named(params) -> dict:
    """``{flat name: value}`` of a port ``Model`` or of a dict as given."""
    if isinstance(params, torch.nn.Module):
        from repro_torch.core.collector import named_params
        return named_params(params)
    return dict(params)


def nest_named(named: dict) -> dict:
    """``{flat name: leaf}`` -> the reference's params tree (dicts, with
    ``layers`` a list)."""
    root: dict = {}
    for name, leaf in named.items():
        *path, last = name.split(".")
        d = root
        for p in path:
            d = d.setdefault(p, {})
        d[last] = leaf
    if "layers" in root:
        root["layers"] = [root["layers"][str(i)]
                          for i in range(len(root["layers"]))]
    return root


def _grad(t: torch.Tensor) -> torch.Tensor:
    # a leaf off the differentiation path has a zero gradient, as in jax.grad
    return t.grad if t.grad is not None else torch.zeros_like(t)


def _on(v, dev, dtype=None) -> torch.Tensor:
    t = v.detach() if isinstance(v, torch.Tensor) else as_tensor(v)
    return t.to(device=dev, dtype=dtype)


class _Plumbing:
    """Everything derived from (cfg, pcfg, params structure) that a
    candidate step needs: mesh, annotations, layout mappers, the body, and
    the (un)sharding with the zigzag (un)permute."""

    def __init__(self, cfg, pcfg: ParallelConfig, device):
        if cfg.attn == "mla" and pcfg.cp > 1:
            # tp_mla_attention runs the plain core over whole sequences
            raise ValueError(f"{cfg.name}: the distributed candidate has no "
                             f"context-parallel MLA attention")
        if cfg.arch_type in ("vlm", "audio"):
            # the reference's parallel_gpt_loss embeds batch["tokens"] alone
            raise ValueError(f"{cfg.name}: the distributed candidate takes "
                             f"token batches only, as the reference's: a "
                             f"{cfg.arch_type} frontend's image_embeds or "
                             f"features have no sharded path")
        self.cfg, self.pcfg = cfg, pcfg
        self.mesh = make_mesh(pcfg, device)
        self.ann = build_annotations(cfg, pcfg)
        self.to_cand, self.from_cand = layout_maps(cfg, pcfg.tp)
        self.sizes = sizes_coords(pcfg)
        # tokens/labels: batch over dp, sequence over cp, after the zigzag
        self.batch_spec = ShardSpec(dp_dim=0, cp_dim=1)
        self.loss_axes = tuple(a for a, n in (("dp", pcfg.dp),
                                              ("cp", pcfg.cp)) if n > 1)

    def body(self, leaves: dict, bb: dict, rew: Optional[dict],
             trace: bool = True):
        """Forward + backward of every rank + gradient reductions; returns
        rank-stacked ``(loss, taps, param grads, act grads)`` (no taps and
        no act grads when ``trace`` is False)."""
        cfg, pcfg, bugs, mesh = self.cfg, self.pcfg, self.pcfg.bugs, self.mesh
        if trace:
            ctx = TraceContext("rewrite" if rew else "collect", rewrites=rew,
                               probes=True)
        else:
            ctx = TraceContext("off")
        for leaf in leaves.values():
            leaf.grad = None
        gloss, rloss = parallel_gpt_loss(mesh, nest_named(leaves), bb, cfg,
                                         pcfg.sp, bugs, ctx)
        # every rank's loss seeds its own backward, as jax.grad of the local
        # loss does inside shard_map
        gloss.sum().backward()
        pg = {n: _grad(leaf) for n, leaf in leaves.items()}
        for leaf in leaves.values():
            leaf.grad = None
        pg = reduce_param_grads(mesh, pg, pcfg, bugs)
        ag = {n: _grad(probe) for n, probe in (ctx.probes or {}).items()}
        ag = reduce_act_grads(mesh, ag, self.ann, pcfg, bugs)
        loss = rloss.detach()
        if self.loss_axes:
            loss = mesh.psum(loss, self.loss_axes) / (pcfg.dp * pcfg.cp)
        return loss, ctx.fwd, pg, ag

    def shard(self, full, spec: ShardSpec):
        """Every rank's shard of ``full`` (a ``NamedSharding``'s placement)."""
        return split_ranks(full, spec, self.sizes)

    def unshard(self, stacked, spec: ShardSpec):
        """The full tensor of every rank's shard (an ``out_specs``'s)."""
        return assemble_ranks(stacked, spec, self.sizes)

    def unzig(self, n, x):
        spec = self.ann.act_spec(n)
        if self.pcfg.cp > 1 and spec.cp_dim is not None:
            return permute_from_zigzag(x, self.pcfg.cp, spec.cp_dim % x.ndim)
        return x

    def zigzag_batch(self, batch: dict) -> dict:
        out = {}
        for k in ("tokens", "labels"):
            v = _on(batch[k], self.mesh.device)
            if self.pcfg.cp > 1:
                v = permute_to_zigzag(v, self.pcfg.cp, 1)
            out[k] = v
        return out

    def layout_spec(self, n) -> ShardSpec:
        """How ranks hold tap ``n`` physically: contiguous blocks of the
        zigzag-permuted sequence, cp-major / sp-minor, as the reference's
        ``PartitionSpec`` lays them out (the annotation's zigzag mode names
        the logical positions, which ``unzig`` restores)."""
        return dataclasses.replace(self.ann.act_spec(n), cp_mode="contiguous")

    def act_out(self, n, x):
        """A rank-stacked tap or probe gradient as its logical full tensor."""
        return self.unzig(n, self.unshard(x, self.layout_spec(n)))

    def act_in(self, n, v):
        """A logical full rewrite as every rank's shard."""
        spec = self.ann.act_spec(n)
        if self.pcfg.cp > 1 and spec.cp_dim is not None:
            v = permute_to_zigzag(v, self.pcfg.cp, spec.cp_dim % v.ndim)
        return self.shard(v, self.layout_spec(n))


def _leaves(pl: _Plumbing, params: dict, dev, dtype) -> dict:
    """One leaf per parameter holding every rank's shard (layout-mapped):
    each rank's slice of its ``.grad`` is that rank's own gradient.
    ``dtype``: ``param_dtypes(cfg)``."""
    return {n: pl.shard(pl.to_cand(n, _on(v, dev, dtype(n))),
                        pl.ann.param_spec(n)).requires_grad_()
            for n, v in params.items()}


def _candidate_trace(pl: _Plumbing, leaves: dict, batch: dict, rewrites=None):
    """The forward/backward sections of one candidate run and its param
    grads in reference layout; ``trace.loss`` stays a device tensor."""
    dev = pl.mesh.device
    b = {k: pl.shard(v, pl.batch_spec)
         for k, v in pl.zigzag_batch(batch).items()}
    rew = None
    if rewrites:
        rew = {n: pl.act_in(n, _on(v, dev)) for n, v in rewrites.items()}
    loss, taps, pg, ag = pl.body(leaves, b, rew)
    names = list(taps)
    tr = Trace()
    tr.loss = loss[0]
    tr.activations = {n: pl.act_out(n, taps[n]) for n in names}
    tr.act_grads = {n: pl.act_out(n, ag[n]) for n in names if n in ag}
    pg_named = {n: pl.from_cand(n, pl.unshard(g, pl.ann.param_spec(n)))
                for n, g in pg.items()}
    tr.param_grads = dict(pg_named)
    tr.meta["fwd_order"] = names
    tr.meta["annotations"] = pl.ann
    tr.meta["pcfg"] = pl.pcfg
    return tr, pg_named


def _update(pcfg: ParallelConfig, opt, params: dict, grads: dict, st):
    """The candidate's optimizer step: plain AdamW or (buggy) ZeRO-1."""
    if pcfg.zero1:
        return zero1_update(opt, params, grads, st, pcfg.dp, pcfg.bugs)
    return opt.update(params, grads, st)


def make_candidate_runner(cfg, pcfg: ParallelConfig, ref_params, opt=None,
                          opt_state=None, device="cuda"):
    """Build ``runner(batch, rewrites) -> Trace`` for the candidate recipe:
    the distributed GPT on emulated ranks, or (dispatching on ``pcfg``) the
    staged pipeline, the 1F1B pipeline or the FP8 candidate.

    ``ref_params``: the reference's parameters, a port ``Model`` or
    ``{flat name: tensor or numpy array}``; a run never changes them.
    Trace leaves stay on ``device``."""
    dev = resolve_device(device)
    check_injectable(pcfg.bugs, candidate_features(cfg, pcfg))
    if pcfg.recipe_kind != "shard_map":
        return _recipe_runner(cfg, pcfg, ref_params, opt, opt_state, dev)
    pl = _Plumbing(cfg, pcfg, dev)
    dtype = param_dtypes(cfg)
    ref = {n: _on(v, dev, dtype(n)) for n, v in _named(ref_params).items()}
    leaves = _leaves(pl, ref, dev, dtype)

    def _run(batch, rewrites=None) -> Trace:
        tr, pg_named = _candidate_trace(pl, leaves, batch, rewrites)
        tr.loss = float(tr.loss)
        if opt is not None:
            st = opt_state if opt_state is not None else opt.init(ref)
            new_p, _, info = _update(pcfg, opt, ref, pg_named, st)
            tr.main_grads = info.main_grads
            tr.params_post = new_p
            tr.grad_norm = float(info.grad_norm)
        return tr

    return _run


# ---------------------------------------------------------------------------
# Stateful candidate train step (the supervisor's lockstep contract)
# ---------------------------------------------------------------------------

def make_candidate_train_step(cfg, pcfg: ParallelConfig, ref_params, opt,
                              device="cuda"):
    """The FULL candidate train step over state threaded by the caller.

    ``make_candidate_runner`` is stateless: it applies the optimizer to the
    reference params it was built with.  The supervisor instead threads the
    candidate's own (params, opt_state) through N steps.  That state stays
    in REFERENCE layout (fused-QKV order, full tensors, ZeRO-1's moments
    included); each step maps it to the rank-stacked candidate layout,
    runs every rank's forward/backward and the gradient reductions, and
    applies the (possibly buggy ZeRO-1) update in reference layout.
    Checkpoints, replays and resumes are therefore layout-free.

    Returns ``(step, params0, opt_state0)`` with ``step(params, opt_state,
    batch) -> (Trace, new_params, new_opt_state)``.  Nothing is updated in
    place, and ``trace.loss`` / ``trace.grad_norm`` stay device tensors.
    Dispatches on ``pcfg.recipe_kind``: the pipeline and FP8 candidates
    return their own steps under the same contract (``parallel.pp``,
    ``parallel.pp1f1b``, ``precision.fp8``)."""
    dev = resolve_device(device)
    check_injectable(pcfg.bugs, candidate_features(cfg, pcfg))
    if pcfg.recipe_kind != "shard_map":
        return _recipe_train_step(cfg, pcfg, ref_params, opt, dev)
    pl = _Plumbing(cfg, pcfg, dev)
    dtype = param_dtypes(cfg)

    def step(params: dict, opt_state: dict, batch: dict):
        leaves = _leaves(pl, params, dev, dtype)
        tr, pg_named = _candidate_trace(pl, leaves, batch)
        new_p, new_st, info = _update(pcfg, opt, params, pg_named, opt_state)
        tr.main_grads = info.main_grads
        tr.params_post = new_p
        tr.grad_norm = info.grad_norm
        return tr, new_p, new_st

    params0 = {n: _on(v, dev, dtype(n)).clone()
               for n, v in _named(ref_params).items()}
    return step, params0, opt.init(params0)


def make_plain_train_step(cfg, pcfg: ParallelConfig, ref_params, opt,
                          device="cuda"):
    """The distributed candidate's train step without any tracing (the
    loss-curve practice the paper contrasts TTrace with, Fig 1).

    Returns ``(step, prep, params0, opt_state0)``: ``prep(batch)`` puts a
    batch on the device, ``step(params, opt_state, batch) -> (params,
    opt_state, loss)``."""
    dev = resolve_device(device)
    check_injectable(pcfg.bugs, candidate_features(cfg, pcfg))
    if pcfg.recipe_kind != "shard_map":
        raise ValueError(f"the plain step is the shard_map candidate's; "
                         f"recipe {pcfg.recipe_kind!r} has none")
    pl = _Plumbing(cfg, pcfg, dev)
    dtype = param_dtypes(cfg)

    def prep(batch: dict) -> dict:
        return {k: _on(batch[k], dev) for k in ("tokens", "labels")}

    def step(params: dict, opt_state: dict, batch: dict):
        leaves = _leaves(pl, params, dev, dtype)
        b = {k: pl.shard(v, pl.batch_spec)
             for k, v in pl.zigzag_batch(batch).items()}
        loss, _, pg, _ = pl.body(leaves, b, None, trace=False)
        grads = {n: pl.from_cand(n, pl.unshard(g, pl.ann.param_spec(n)))
                 for n, g in pg.items()}
        new_p, new_st, _ = _update(pcfg, opt, params, grads, opt_state)
        return new_p, new_st, loss[0]

    params0 = {n: _on(v, dev, dtype(n)).clone()
               for n, v in _named(ref_params).items()}
    return step, prep, params0, opt.init(params0)

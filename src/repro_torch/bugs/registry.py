"""Silent-bug injection registry: a copy of ``repro/bugs/registry.py``.

The port keeps the reference's whole table (Table 1 taxonomy: W-CP wrong
computation, W-CM wrong communication, M-CM missing communication), so its
tests and ``chip_smoke.py`` read each bug's ``expected_module`` from here.
Every entry but those in ``PENDING`` is injectable: ``fp8_stale_scale``
through ``precision.fp8``, the three ``pp_*`` bugs through the pipeline
candidates (``parallel.pp``, ``parallel.pp1f1b``), the rest through
``parallel.api`` (the distributed candidate; ``moe_router_not_synced``
through its expert-parallel MoE blocks).  ``PENDING`` would name the
ROADMAP item that brings a bug the port cannot inject yet (none is left);
``check_injectable`` refuses such a bug rather than run a clean candidate
under its name.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BugSpec:
    bug_id: str
    btype: str          # W-CP | W-CM | M-CM
    paper_analogue: str  # Table 1 row this mirrors
    description: str
    impact: str
    expected_module: str  # module (or prefix) TTrace should localize to
    requires: tuple = ()  # parallel features that must be on ("tp","cp",...)


BUGS: dict[str, BugSpec] = {b.bug_id: b for b in [
    BugSpec("tp_wrong_embedding_mask", "W-CP", "bug 1 (TP wrong embedding mask)",
            "vocab-parallel embedding uses an off-by-one ownership mask; "
            "boundary tokens are embedded by two ranks and double-counted "
            "after the all-reduce",
            "wrong forward + gradients", "embedding*", ("tp",)),
    BugSpec("ar_stale_recompute", "W-CP", "bug 2 (AR wrong input)",
            "activation recomputation re-runs the MLP on a stale "
            "(token-shifted) input during the backward pass",
            "wrong gradients only", "layers.*.mlp*", ()),
    BugSpec("cp_wrong_loss_scale", "W-CP", "bug 3 (CP wrong loss scaling)",
            "per-rank loss contribution divided by local token count instead "
            "of global under context parallelism",
            "wrong gradients", "loss", ("cp",)),
    BugSpec("dp_wrong_loss_scale", "W-CP", "bug 4 (DP wrong loss scaling)",
            "data-parallel gradient all-reduce uses sum instead of mean",
            "wrong gradients (scaled by dp)", "loss", ("dp",)),
    BugSpec("zero_untied_embedding", "W-CM", "bug 5 (ZeRO embed/LM-head untied)",
            "with tied embeddings + ZeRO-1, the embedding and LM-head shards "
            "are updated from different owner ranks and drift apart",
            "wrong parameter update", "embedding*", ("zero1",)),
    BugSpec("moe_router_not_synced", "M-CM", "bug 6 (SP router not synced)",
            "router weights initialized per-rank without broadcast inside "
            "the TP group; routing decisions diverge across ranks",
            "wrong forward + gradients", "layers.*.mlp", ("tp", "moe")),
    BugSpec("tp_wrong_allreduce_axis", "W-CM", "bug 7 (wrong FP8 comm group)",
            "row-parallel output all-reduce runs over the dp axis instead of "
            "the tp axis",
            "wrong forward + gradients", "layers.*.self_attention", ("tp", "dp")),
    BugSpec("fp8_stale_scale", "W-CP", "bug 8 (AR wrong tensor by FP8 cast)",
            "fp8 matmul quantizes with a stale amax scale (previous tensor)",
            "wrong loss", "layers.*.mlp", ("fp8",)),
    BugSpec("zero_skipped_update", "W-CM", "bug 9 (ZeRO param update failure)",
            "ZeRO-1 all-gather after the step returns the pre-update shard "
            "for the last rank's partition; those params never train",
            "no parameter update (partial)", "optimizer", ("zero1",)),
    BugSpec("pp_wrong_stage_division", "W-CP", "bug 10 (PP wrong stage division)",
            "pipeline stage boundaries computed with a rounded layers-per-"
            "stage; one layer is executed twice, another skipped",
            "wrong model gets trained", "layers.*", ("pp",)),
    BugSpec("pp_microbatch_order", "W-CP",
            "Megatron microbatch-schedule bug class (Yu et al.)",
            "the 1F1B backward recompute reads the NEXT microbatch's "
            "stashed boundary input, so gradients are accumulated against "
            "the wrong microbatch's activations; the forward pass — and "
            "therefore the loss curve — is byte-identical to the correct "
            "schedule",
            "wrong gradients only", "layers.*", ("pp", "1f1b")),
    BugSpec("pp_stale_boundary", "W-CM",
            "boundary-communication bug class (Yu et al.)",
            "stage i+1 consumes the previous microbatch's boundary "
            "activation (stale recv buffer reuse); microbatch 0 is correct "
            "and every consumed tensor is a real activation, so the loss "
            "stays plausible and keeps decreasing",
            "wrong forward + gradients", "layers.*", ("pp", "1f1b")),
    BugSpec("sp_stale_wgrad", "W-CP", "bug 11 (wrong grads w/ overlap)",
            "row-parallel linear_proj weight gradient computed from a stale "
            "(half-zeroed) activation buffer, as if the overlapped backward "
            "all-gather never completed; forward and dgrad are correct",
            "wrong gradients only", "layers.*.self_attention*", ("tp", "sp")),
    BugSpec("tp_missing_grad_allreduce", "M-CM", "bug 11 class (missing grad AR)",
            "gradient of the (tp-replicated) input_norm weight is not "
            "all-reduced over the tp group under sequence parallelism",
            "wrong gradients", "layers.*.input_norm", ("tp", "sp")),
    BugSpec("sp_layernorm_not_synced", "M-CM", "bug 12 (SP layernorm not synced)",
            "with sequence parallelism, post_attn_norm weight grads come "
            "from local sequence shards and are never reduced over the sp "
            "group",
            "wrong gradients", "layers.*.post_attn_norm", ("tp", "sp")),
    BugSpec("cp_wrong_attention_grad", "W-CP", "bug 13 (CP wrong attn grads)",
            "context-parallel attention backward uses the first zigzag "
            "stripe's positions for both stripes (forward is correct)",
            "wrong gradients only", "layers.*.self_attention*", ("cp",)),
    BugSpec("tp_cp_wrong_norm_grad", "W-CP", "bug 14 (TP+CP wrong LN grads)",
            "input_norm weight gradient is reduced over the sp group but "
            "its context-parallel reduction is skipped when TP+CP combine",
            "wrong gradients", "layers.*.input_norm", ("tp", "cp")),
    BugSpec("tp_missing_row_psum", "M-CM", "classic missing all-reduce",
            "row-parallel MLP down-projection output is never all-reduced; "
            "each rank continues with a partial sum",
            "wrong forward + gradients", "layers.*.mlp", ("tp",)),
]}


def bug(bug_id: str) -> BugSpec:
    return BUGS[bug_id]


def available_for(features: set[str]) -> list[BugSpec]:
    return [b for b in BUGS.values() if set(b.requires) <= features]


# bugs whose recipes are not ported yet, with the ROADMAP item of each
PENDING: dict[str, str] = {}


def injectable() -> set[str]:
    return set(BUGS) - set(PENDING)


def check_injectable(bugs, features: set[str]) -> None:
    """Raise unless every id in ``bugs`` is known, injectable in the port,
    and expressible by a candidate with ``features``."""
    unknown = set(bugs) - set(BUGS)
    if unknown:
        raise KeyError(f"unknown bug ids {sorted(unknown)}")
    for b in sorted(set(bugs) & set(PENDING)):
        raise NotImplementedError(f"bug {b!r} cannot be injected in the "
                                  f"port yet: {PENDING[b]}")
    for b in sorted(bugs):
        missing = set(BUGS[b].requires) - set(features)
        if missing:
            raise ValueError(f"bug {b!r} needs {sorted(missing)}, which "
                             f"this candidate does not run")

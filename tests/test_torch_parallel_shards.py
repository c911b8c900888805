"""The port's annotations, shard slicing, merger and device assembler
against the reference's (``repro.core.annotations``, ``generator``,
``merger``) on the same inputs.  Every ``ShardSpec`` axis is covered, zigzag
context parallelism included."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402
from repro.core import annotations as jann  # noqa: E402
from repro.core import generator as jgen  # noqa: E402
from repro.core import merger as jmerge  # noqa: E402
from repro.parallel import api as japi  # noqa: E402
from repro_torch.core import annotations as tann  # noqa: E402
from repro_torch.core import generator as tgen  # noqa: E402
from repro_torch.core import merger as tmerge  # noqa: E402
from repro_torch.parallel import api as tapi  # noqa: E402

SHAPE = (4, 16, 8)
# (spec kwargs, sizes): every axis alone, zigzag and contiguous cp, and
# the combinations the distributed candidate's annotations use
CASES = [
    (dict(tp_dim=0), dict(tp=2)),
    (dict(tp_dim=-1), dict(tp=4)),
    (dict(sp_dim=1), dict(tp=2, sp=2)),
    (dict(cp_dim=1), dict(cp=2)),
    (dict(cp_dim=1, cp_mode="zigzag"), dict(cp=2)),
    (dict(dp_dim=0), dict(dp=2)),
    (dict(ep_dim=0), dict(ep=2)),
    (dict(dp_dim=0, cp_dim=1, cp_mode="zigzag", sp_dim=1),
     dict(dp=2, cp=2, tp=2, sp=2)),
    (dict(dp_dim=0, cp_dim=1, cp_mode="zigzag", tp_dim=-1),
     dict(dp=2, cp=2, tp=2, sp=2)),
    (dict(dp_dim=0, cp_dim=1, cp_mode="zigzag"), dict(dp=2, cp=2, tp=2)),
    (dict(tp_dim=1), dict(dp=2, cp=2, tp=2)),
    (dict(), dict(dp=2, cp=2, tp=2)),
]
IDS = [f"{'-'.join(f'{k}{v}' for k, v in s.items()) or 'replicated'}"
       f"@{'-'.join(f'{k}{v}' for k, v in z.items())}" for s, z in CASES]


def setup_module():
    one_thread()


def _coords(sizes):
    axes = list(sizes)
    for combo in itertools.product(*(range(sizes[a]) for a in axes)):
        yield dict(zip(axes, combo)), tuple(combo)


def _full(seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


@pytest.mark.parametrize("spec_kw,sizes", CASES, ids=IDS)
def test_slices_and_extract_match_reference(spec_kw, sizes):
    js, ts = jann.ShardSpec(**spec_kw), tann.ShardSpec(**spec_kw)
    assert js.replicated_axes == ts.replicated_axes
    assert jann.shard_concat_dim(js) == tann.shard_concat_dim(ts)
    full = _full()
    for coords, _ in _coords(sizes):
        assert (jann.slices_for_rank(js, SHAPE, sizes, coords)
                == tann.slices_for_rank(ts, SHAPE, sizes, coords))
        np.testing.assert_array_equal(
            jgen.extract_shard(full, js, sizes, coords),
            tgen.extract_shard(full, ts, sizes, coords))
        np.testing.assert_array_equal(
            jgen.generate_shard("w", SHAPE, js, sizes, coords),
            tgen.generate_shard("w", SHAPE, ts, sizes, coords))


def _report(rep):
    return (rep.ok, rep.overlap, rep.omission, rep.conflicts,
            rep.layout_mismatches, rep.problems())


def _merge_both(shards, spec_kw, sizes):
    jm, jr = jmerge.merge_shards(shards, jann.ShardSpec(**spec_kw), sizes,
                                 SHAPE)
    tm, tr = tmerge.merge_shards(shards, tann.ShardSpec(**spec_kw), sizes,
                                 SHAPE)
    np.testing.assert_array_equal(jm, tm)
    assert _report(jr) == _report(tr)
    return tm, tr


@pytest.mark.parametrize("spec_kw,sizes", CASES, ids=IDS)
def test_merge_shards_matches_reference(spec_kw, sizes):
    full = _full()
    spec = tann.ShardSpec(**spec_kw)
    shards = {ct: tgen.extract_shard(full, spec, sizes, c)
              for c, ct in _coords(sizes)}
    merged, rep = _merge_both(shards, spec_kw, sizes)
    assert rep.ok, rep.problems()
    np.testing.assert_array_equal(merged, full)


def test_merge_reports_match_reference():
    """Omission, a replica conflict, a layout mismatch and an overlap (a
    zigzag rank listed past the cp degree owns rank 1's stripes in the other
    order) give the reference's report."""
    full = _full()
    zig = dict(cp_dim=1, cp_mode="zigzag")
    sizes = dict(cp=2, tp=2)
    spec = tann.ShardSpec(**zig)
    shards = {ct: tgen.extract_shard(full, spec, sizes, c)
              for c, ct in _coords(sizes)}

    omitted = {k: v for k, v in shards.items() if k != (1, 0)}
    omitted.pop((1, 1))
    _, rep = _merge_both(omitted, zig, sizes)
    assert not rep.ok and rep.omission == full.size // 2

    conflict = dict(shards)
    conflict[(0, 1)] = conflict[(0, 1)] * np.float32(1.01)
    _, rep = _merge_both(conflict, zig, sizes)
    assert not rep.ok and len(rep.conflicts) == 1

    wrong = dict(shards)
    wrong[(1, 1)] = wrong[(1, 1)][:, :3]
    _, rep = _merge_both({(0, 0): shards[(0, 0)], (1, 0): wrong[(1, 1)]},
                         zig, sizes)
    assert not rep.ok and rep.layout_mismatches

    over = {(0,): shards[(0, 0)], (1,): shards[(1, 0)],
            (2,): tgen.extract_shard(full, spec, {"cp": 2}, {"cp": 2})}
    _, rep = _merge_both(over, zig, {"cp": 2})
    assert not rep.ok and rep.overlap == full.size // 2


@pytest.mark.parametrize("spec_kw,sizes", [c for c in CASES
                                           if "ep" not in c[1]],
                         ids=[i for i, c in zip(IDS, CASES)
                              if "ep" not in c[1]])
def test_device_assembler_equals_merge_shards(spec_kw, sizes):
    """``assemble_ranks`` of a rank-stacked tensor equals ``merge_shards``
    of the same shards, and ``split_ranks`` is its inverse."""
    spec = tann.ShardSpec(**spec_kw)
    full = _full(1)
    ranks = tmerge.rank_coords(sizes)
    shards = [tgen.extract_shard(full, spec, sizes, c) for c in ranks]
    stacked = torch.from_numpy(np.stack(shards))
    keyed = {tuple(c[a] for a in sizes): s for c, s in zip(ranks, shards)}
    merged, rep = tmerge.merge_shards(keyed, spec, sizes, SHAPE)
    assert rep.ok, rep.problems()
    got = tmerge.assemble_ranks(stacked, spec, sizes)
    np.testing.assert_array_equal(got.numpy(), merged)
    assert torch.equal(tmerge.split_ranks(torch.from_numpy(full), spec, sizes),
                       stacked)


PCFGS = [dict(dp=2, tp=2), dict(dp=2, tp=2, sp=True),
         dict(dp=2, cp=2, tp=2, sp=True), dict(dp=2, cp=2, tp=2),
         dict(dp=2, tp=2, zero1=True), dict(fp8="tile128"),
         dict(pp=2, pp_schedule="1f1b", microbatches=2)]


@pytest.mark.parametrize("kw", PCFGS, ids=str)
def test_parallel_config_and_annotations_match_reference(kw):
    from _torch_parity import configs
    jc, tc = configs("tinyllama-1.1b")
    jp, tp = japi.ParallelConfig(**kw), tapi.ParallelConfig(**kw)
    assert (jp.features, jp.recipe_kind, jp.n_devices) == (
        tp.features, tp.recipe_kind, tp.n_devices)
    assert japi.sizes_coords(jp) == tapi.sizes_coords(tp)
    ja, ta = japi.build_annotations(jc, jp), tapi.build_annotations(tc, tp)
    names = ["embedding.word_embeddings", "lm_head", "final_norm",
             "layers.1.self_attention.linear_qkv.w",
             "layers.0.self_attention.linear_proj.w", "layers.1.mlp.down.w",
             "layers.0.mlp.gate.w", "layers.0.input_norm"]
    for n in names:
        assert (dataclasses.asdict(ja.param_spec(n))
                == dataclasses.asdict(ta.param_spec(n)))
    for n in ["embedding/output", "layers.0.self_attention/input",
              "layers.1.self_attention/core_attn_out", "layers.0.mlp/output",
              "final_norm_out", "layers.1.mlp/router_logits"]:
        assert (dataclasses.asdict(ja.spec_for("activation", n))
                == dataclasses.asdict(ta.spec_for("activation", n)))
    if tp.tp > 1:
        np.testing.assert_array_equal(japi.qkv_permutation(jc, tp.tp),
                                      tapi.qkv_permutation(tc, tp.tp))

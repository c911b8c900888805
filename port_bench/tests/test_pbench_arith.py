"""The frozen arithmetic against what the program runs: a training
step's FLOPs against ``FlopCounterMode`` over the port's traced step, and
``packed_sq_norms``' packed size against ``pack_device``'s layout."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import arith, harness, weights
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("arith"))


@pytest.mark.parametrize("cell", ["q", "m"])
def test_step_flops_match_the_programs_step(root, cell):
    from repro_torch.core.collector import trace_train_step
    from repro_torch.models.moe import expert_capacity
    c = harness.load_cell(cell, root)
    cfg, tr = c.config, c.traffic
    prog = harness.Program(c, 7, torch.device("cpu"))
    B, S = tr["batch"], tr["seq"]
    batch = weights.batch(cfg["vocab_size"], B, S, 7, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        trace_train_step(prog.model, batch)
    rows = None
    if cfg.get("num_local_experts"):
        rows = cfg["num_local_experts"] * expert_capacity(
            B * S, prog.model.cfg.moe)
    assert counter.get_total_flops() == arith.step_flops(cfg, B, S, rows)
    # the model FLOPs count the routed rows, not the capacity buffer
    assert arith.step_flops(cfg, B, S) <= counter.get_total_flops()


def test_packed_size_matches_pack_device():
    from repro_torch.kernels.relerr import pack_device
    sizes = [1, 1023, 1024, 1025, 5000]
    a = [torch.ones(n) for n in sizes]
    flat, _, seg_ids, _ = pack_device(a, a)
    assert flat.numel() == arith.packed_elems(sizes)
    nbytes, ops = arith.packed_sq_norms_cost(sizes)
    assert nbytes == 8 * flat.numel() + 8 * seg_ids.numel() + 8 * len(sizes)
    assert ops == 4 * flat.numel()


def test_full_width_flops():
    """The frozen counts the cells' mfu reads: 62.8 and 41.2 TFLOP a
    check of three steps at 1 x 4096."""
    for name, tflop in (("codeqwen1.5-7b", 62.78), ("mixtral-8x7b", 41.21)):
        cfg = json.loads((tiny.PB / f"configs/{name}.json").read_text())
        assert abs(3 * arith.step_flops(cfg, 1, 4096) / 1e12 - tflop) < 0.01


def _roofline_rec(launches):
    sizes = {"activation": [4096, 8192], "param_grad": [100, 200]}
    return {"profile": {"kernel_s": {"void block_partials<1024>": 1e-3,
                                     "void segment_sums": 1e-4},
                        "launches": {"void block_partials<1024>": launches,
                                     "void segment_sums": launches}},
            "checks": [{"profiled": True}, {"profiled": True}],
            "sizes": sizes,
            "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}}


def test_relerr_roofline_counts_the_launches_it_reads():
    """The reader's bytes are those of one launch a packed section and one
    over every pair, in each profiled check; with any other count of
    ``block_partials`` launches in the trace it reports nothing."""
    read = harness.load_module(tiny.PB / "metrics/relerr_roofline.py").read
    assert read(_roofline_rec(4)) > 0
    for launches in (2, 3, 5, 6):
        assert read(_roofline_rec(launches)) is None

"""The harness on tiny cells written from files alone, on the CPU: a
whole run (window, trace reduction, comparison), a cell and a per-layer
metric added with no edit to the harness, each fault of ``faults.py``
turning ``correct`` false, and the float8 control failing the limits the
program passes."""
from __future__ import annotations

import pytest
import torch

from port_bench import faults, harness, judge
from port_bench.reference import common
from port_bench.tests import tiny

SEED = 3_141_592_653


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.write_root(tmp_path_factory.mktemp("pbench"),
                           extra_metric="dummy_check_s")
    (root / "port_bench/metrics/dummy_check_s.py").write_text(
        "def read(rec):\n"
        "    return sum(c['wall_s'] for c in rec['checks'])"
        " / len(rec['checks'])\n")
    return root


def test_dummy_cell_from_files_alone(root):
    res, lines = harness.run_cell("m", SEED, 0.2, True, device="cpu",
                                  root=root, log=lambda _: None)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"estimate_s", "candidate_s", "compare_s",
            "dummy_check_s"} <= set(res["metrics"])
    # the device readers find nothing to read on the CPU and say nothing
    assert not {"relerr_roofline", "idle_share.check",
                "mfu.check"} & set(res["metrics"])
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(tiny.LIMITS["m"])


def test_end_to_end_metrics_and_verdict(root):
    res, lines = harness.run_cell("q", SEED + 1, 0.2, False, device="cpu",
                                  root=root, log=lambda _: None)
    assert res["correct"], lines
    assert set(res["metrics"]) == {"check_s", "check_peak_gib", "setup_s"}
    assert res["metrics"]["check_s"]["value"] > 0
    assert len(lines) == len(tiny.LIMITS["q"])


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_turns_correct_false(root, fault):
    with faults.FAULTS[fault]():
        res, lines = harness.run_cell("q", SEED + 2, 0.0, False,
                                      device="cpu", root=root,
                                      log=lambda _: None)
    assert not res["correct"], lines


def test_control_fails_where_program_passes(root):
    cell = harness.load_cell("q", root)
    dev = torch.device("cpu")
    ref = harness.reference(cell, SEED + 3, dev)
    prog = harness.Program(cell, SEED + 3, dev)
    sound = judge.numbers(prog.readings(prog.check(0)), ref)
    ctrl = judge.numbers(judge.reference_readings(
        harness.reference(cell, SEED + 3, dev, common.FP8)), ref)
    limits = {k: v for k, v in cell.limits.items() if k in ctrl}
    assert judge.judge(sound, cell.limits)[0]
    assert not judge.judge(ctrl, limits)[0]


def test_reference_follows_the_window(tmp_path):
    """The Mixtral reference's sliding window against the program's plain
    runner at a window shorter than the sequence (the tp candidate
    ignores the window, so the runner stands in on both sides)."""
    import json
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.optim.adamw import AdamW
    root = tiny.write_root(tmp_path)
    path = root / "port_bench/configs/tiny-mixtral.json"
    cfg = json.loads(path.read_text())
    cfg["sliding_window"] = 16
    path.write_text(json.dumps(cfg))
    cell = harness.load_cell("m", root)
    dev = torch.device("cpu")
    prog = harness.Program(cell, SEED + 4, dev)
    run = make_model_runner(prog.model, AdamW(**cell.traffic["optimizer"]),
                            device=dev)
    batch = harness.weights.batch(cfg["vocab_size"], 2, 32, SEED + 4, 0, dev)
    res = ttrace_check(run, run, batch, eps=cell.traffic["threshold_eps"],
                       localize=False)
    nums = judge.numbers(prog.readings(res),
                         harness.reference(cell, SEED + 4, dev))
    assert nums["grads"] < 1e-4 and nums["acts"] < 1e-4, nums

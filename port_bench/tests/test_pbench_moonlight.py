"""The DeepSeek-V3 family on a tiny cell written from files alone, on the
CPU, as ``tiny.py``'s cells: a traced run of the harness (window, trace
reduction, comparison) reports ``moe_s`` and ``mla_s``; the plain
reference agrees with the program's plain runner; the float8 control and
each fault of ``faults.py`` turn ``correct`` false; ``arith_mla``'s count
is the program's step as ``FlopCounterMode`` counts it.

The cell ``v`` is ``moonlight-16b-a3b``'s file at hidden size 64, 4
heads, 3 layers (the dense one, then 2 MoE), a router of 8 experts
choosing 3, 4 of them held from expert 2, vocabulary 256, in float32 (a
bf16 token whose choice flips between the two sides moves its expert's
gradient past the bf16 thresholds at this size).  Its latent attention
keeps the published widths: the program takes them from its own
``moonlight-16b-a3b``.  The limits were read from the CPU runs of
``control.py --device cpu`` on this cell."""
from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import arith_mla, faults, harness, judge, weights
from port_bench.reference import common
from port_bench.tests import tiny

SEED = 2_904_161_803
LIMITS = {"loss": 1e-5, "grads": 1e-4, "update": 3e-5, "acts": 1e-4,
          "thresholds": 1.8, "relerr": 1e-9, "verdicts": 0}
SPANS = ("moe_s", "mla_s")


def setup_module():
    torch.set_num_threads(1)


def write_root(root):
    pb = root / "port_bench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((tiny.PB / "configs/moonlight-16b-a3b.json").read_text())
    cfg.update(name="tiny-moonlight", hidden_size=64, intermediate_size=96,
               moe_intermediate_size=32, num_attention_heads=4,
               num_key_value_heads=4, num_hidden_layers=3, vocab_size=256,
               router_experts=8, n_routed_experts=4, held_offset=2,
               num_experts_per_tok=3, torch_dtype="float32",
               compute_dtype="float32")
    (pb / "configs/tiny-moonlight.json").write_text(json.dumps(cfg))
    tr = json.loads((tiny.PB / "traffic/tp2.4x4096.json").read_text())
    tr.update(batch=2, seq=32)
    (pb / "traffic/tiny-v.json").write_text(json.dumps(tr))
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(name=cfg["name"], source="test", reduced=[],
                             why="test",
                             file="port_bench/configs/tiny-moonlight.json")]
    bench["workloads"] = [dict(name="v", config=cfg["name"],
                               traffic="tiny-v", chips=1, why="test")]
    bench["per_layer"] = [dict(m, workloads=["v"]) for m in bench["per_layer"]
                          if m["name"] in SPANS + ("mfu.check.mla",)]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (pb / "limits/v.json").write_text(json.dumps({"limits": LIMITS}))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_root(tmp_path_factory.mktemp("pbench_moonlight"))


def test_traced_run_reports_the_layer_spans(root):
    res, lines = harness.run_cell("v", SEED, 0.0, True, device="cpu",
                                  root=root, log=lambda _: None)
    assert res["correct"], lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SPANS) <= set(got) and all(got[k] > 0 for k in SPANS)
    # the device reader finds nothing to read on the CPU
    assert "mfu.check.mla" not in got


def test_reference_follows_the_programs_plain_runner(root):
    """The reference against the program's plain runner on both sides of
    a check, at the held share from expert 2 and with the bias moving the
    router's choice."""
    from repro_torch.core.harness import make_model_runner, ttrace_check
    from repro_torch.optim.adamw import AdamW
    cell = harness.load_cell("v", root)
    dev = torch.device("cpu")
    prog = harness.Program(cell, SEED + 1, dev)
    bias = prog.values["layers.0.mlp.score_correction.b"]
    assert bias.abs().max() > 0 and bias.dtype == torch.float32
    run = make_model_runner(prog.model, AdamW(**cell.traffic["optimizer"]),
                            device=dev)
    batch = weights.batch(cell.config["vocab_size"], 2, 32, SEED + 1, 0, dev)
    res = ttrace_check(run, run, batch, eps=cell.traffic["threshold_eps"],
                       localize=False)
    nums = judge.numbers(prog.readings(res),
                         harness.reference(cell, SEED + 1, dev))
    assert nums["loss"] < 1e-6 and nums["grads"] < 1e-5, nums
    assert nums["acts"] < 1e-5 and nums["update"] < 1e-5, nums


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_turns_correct_false(root, fault):
    with faults.FAULTS[fault]():
        res, lines = harness.run_cell("v", SEED + 2, 0.0, False,
                                      device="cpu", root=root,
                                      log=lambda _: None)
    assert not res["correct"], lines


def test_control_fails_where_program_passes(root):
    cell = harness.load_cell("v", root)
    dev = torch.device("cpu")
    ref = harness.reference(cell, SEED + 3, dev)
    prog = harness.Program(cell, SEED + 3, dev)
    sound = judge.numbers(prog.readings(prog.check(0)), ref)
    ctrl = judge.numbers(judge.reference_readings(
        harness.reference(cell, SEED + 3, dev, common.FP8)), ref)
    limits = {k: v for k, v in cell.limits.items() if k in ctrl}
    assert judge.judge(sound, cell.limits)[0]
    assert not judge.judge(ctrl, limits)[0]


def test_step_flops_match_the_programs_step(root):
    from repro_torch.core.collector import trace_train_step
    from repro_torch.models.moe import expert_capacity
    c = harness.load_cell("v", root)
    cfg, tr = c.config, c.traffic
    prog = harness.Program(c, 7, torch.device("cpu"))
    B, S = tr["batch"], tr["seq"]
    batch = weights.batch(cfg["vocab_size"], B, S, 7, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        trace_train_step(prog.model, batch)
    rows = cfg["n_routed_experts"] * expert_capacity(B * S,
                                                     prog.model.cfg.moe)
    assert counter.get_total_flops() == arith_mla.step_flops(cfg, B, S, rows)
    assert arith_mla.step_flops(cfg, B, S) <= counter.get_total_flops()


def test_full_width_flops():
    """The frozen count ``mfu.check.mla`` reads: 112.2 TFLOP a check of
    three steps at 4 x 4096."""
    cfg = json.loads((tiny.PB / "configs/moonlight-16b-a3b.json").read_text())
    assert abs(3 * arith_mla.step_flops(cfg, 4, 4096) / 1e12 - 112.21) < 0.01

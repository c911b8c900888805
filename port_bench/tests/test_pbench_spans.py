"""The readers of the program's spans on the tiny cells, on the CPU:
``perturb_s``, ``estimate_runs_s`` and ``pack_s`` are reported in a traced
run of each cell, the estimate's children lie inside ``estimate_s``, and
the device-trace readers still find nothing to read."""
from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

SEED = 2_718_281_828
SPANS = ("perturb_s", "estimate_runs_s", "pack_s")
DEVICE = ("relerr_roofline", "idle_share.check", "mfu.check")


def setup_module():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("pbench_spans"))


@pytest.mark.parametrize("cell", ["q", "m"])
def test_span_readers_report_on_a_traced_run(root, cell):
    res, lines = harness.run_cell(cell, SEED, 0.0, True, device="cpu",
                                  root=root, log=lambda _: None)
    assert res["correct"], lines
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SPANS) <= set(got)
    assert all(got[k] > 0 and v["unit"] == "s"
               for k, v in res["metrics"].items() if k in SPANS)
    assert got["estimate_runs_s"] + got["perturb_s"] <= got["estimate_s"]
    assert got["pack_s"] <= got["estimate_s"] + got["compare_s"]
    assert not set(DEVICE) & set(got)

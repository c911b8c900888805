"""``BENCHMARK.json`` against the benchmark's contract, and every cell
resolved to its files."""
from __future__ import annotations

import json
import re

import pytest

from port_bench import harness
from port_bench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTHS = ("hidden_size", "intermediate", "latent", "state", "proj",
          "head_dim", "expan", "per_tok")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_and_names():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    cmd = BENCH["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert any(w.startswith(BENCH["paths"][0] + "/") for w in cmd)
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(e["name"] for e in BENCH["end_to_end"] + BENCH["per_layer"])) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert (REPO / "port_bench/metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and _line(w["why"])
    c = harness.load_cell(cell)
    conf = {x["name"]: x for x in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("port_bench/")
    assert c.config["name"] == w["config"]
    assert c.config["source"] == conf["source"]
    # every cut is listed, none is a width, and the file says why
    assert sorted(conf["reduced"]) == sorted(c.config["cuts"])
    for key in conf["reduced"]:
        assert NAME.match(key)
        assert not any(t in key for t in WIDTHS), key
        assert not key.endswith(("_dim", "_rank")), key
    harness.family(c)
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer


def test_files_named_from_names():
    for p in (REPO / "port_bench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert PATH.match(str(p.relative_to(REPO))), p

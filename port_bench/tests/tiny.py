"""A benchmark root of tiny cells, written from files alone: the tests'
stand-in for the full-width cells, which run only on the card.

``tiny-qwen`` is the Qwen1.5 family in bf16 against its tp 2 + sp
candidate; ``tiny-mixtral`` the Mixtral family (4 experts, top 2) in
float32 against its tp 2 candidate (at this size a bf16 token whose top-2
flips between the two sides moves its expert's gradient past the bf16
thresholds).  Their limits were read from the CPU runs of
``control.py --device cpu`` on these cells.
"""
from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "port_bench"

LIMITS = {"q": {"loss": 3e-4, "grads": 4e-3, "update": 0.05, "acts": 2e-3,
                "thresholds": 1.8, "relerr": 5e-8, "verdicts": 0},
          "m": {"loss": 1e-5, "grads": 1e-4, "update": 3e-5, "acts": 1e-4,
                "thresholds": 1.8, "relerr": 1e-9, "verdicts": 0}}


def write_root(root: Path, extra_metric: str | None = None) -> Path:
    """Tiny cells ``q`` and ``m`` under ``root`` (the harness finds the
    families and metric readers of ``port_bench/`` beside them);
    ``extra_metric`` names a per-layer metric whose reader the caller
    writes to ``root/port_bench/metrics/<name>.py``."""
    pb = root / "port_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    q = json.loads((PB / "configs/codeqwen1.5-7b.json").read_text())
    q.update(name="tiny-qwen", hidden_size=64, intermediate_size=96,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, vocab_size=256)
    m = json.loads((PB / "configs/mixtral-8x7b.json").read_text())
    m.update(name="tiny-mixtral", hidden_size=64, intermediate_size=96,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=2, vocab_size=256, num_local_experts=4,
             sliding_window=32, tie_word_embeddings=False,
             torch_dtype="float32", compute_dtype="float32")
    for cfg in (q, m):
        (pb / f"configs/{cfg['name']}.json").write_text(json.dumps(cfg))
    for name, src in (("tiny-sp", "tp2sp.1x4096"), ("tiny", "tp2.1x4096")):
        tr = json.loads((PB / f"traffic/{src}.json").read_text())
        tr.update(batch=2, seq=32)
        (pb / f"traffic/{name}.json").write_text(json.dumps(tr))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        dict(name=c["name"], source="test", reduced=[], why="test",
             file=f"port_bench/configs/{c['name']}.json") for c in (q, m)]
    bench["workloads"] = [
        dict(name="q", config="tiny-qwen", traffic="tiny-sp", chips=1,
             why="test"),
        dict(name="m", config="tiny-mixtral", traffic="tiny", chips=1,
             why="test")]
    for metric in bench["per_layer"]:
        metric["workloads"] = ["q", "m"]
    if extra_metric:
        bench["per_layer"].append(dict(
            name=extra_metric, unit="s", better="lower",
            source="program_span", layer="test", moves="check_s",
            workloads=["m"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell, limits in LIMITS.items():
        (pb / f"limits/{cell}.json").write_text(json.dumps(
            {"limits": limits}))
    return root
